// Hand-written Hopper (sm_90a) kernels of the refinement path: instance
// statistics, initial-mask encoding and pixel grouping.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes by quber_tpu_torch/ops/kernels.py (which also holds the build
// command). Every entry point takes a leading batch dimension, launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() so
// that a refused launch is reported.
//
// What the three kernels share, and why:
//   * Tables are compacted. Each block writes the ascending list of the
//     instances (or centres) that count into shared memory, so the main
//     loops run over exactly those entries with no branch, and the compiler
//     can unroll them and keep several independent loads in flight.
//   * Loads and stores are 16 bytes a thread. The mask stack is bytes and
//     the H100 needs roughly 15 KB in flight on each SM to reach its
//     3.35 TB/s; a byte a thread cannot get there. Sixteen pixels of one
//     instance are one uint4, and the arithmetic on them stays packed
//     (byte-lane multiply and max, dp4a sums).
//   * Each kernel has a vector variant and a scalar variant in this file.
//     The launch function takes the vector one when the frame's width and
//     the base pointers allow 16-byte accesses and the scalar one for every
//     other size or view. Both compute the same function.
//
// Float rounding is pinned to match the plain torch versions bit for bit:
// products and sums use __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into FMAs, rounding is rintf (half to even, like torch.round),
// and the exponential is expf (not __expf). The library is also compiled
// with --fmad=false and without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kOnes = 0x01010101u;

// Ascending compaction across the block, one entry a thread and round.
// Every thread calls it; returns the slot of this thread's entry in the
// compacted list (-1 if `flag` is false) and adds the round's count to
// `base`. `s_wcnt` holds one int for each warp of the block.
__device__ __forceinline__ int compact_slot(bool flag, int& base, int* s_wcnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(kFullMask, flag);
  if (lane == 0) s_wcnt[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  int total = 0;
  for (int i = 0; i < n_warps; ++i) {
    const int c = s_wcnt[i];
    before += i < warp ? c : 0;
    total += c;
  }
  const int slot = flag ? base + before + __popc(ballot & ((1u << lane) - 1u)) : -1;
  base += total;
  __syncthreads();
  return slot;
}

// ---------------------------------------------------------------------------
// instance_stats: replaces the XLA reductions of ops.encoding.instance_stats
// in the JAX package (quber_tpu/ops/encoding.py:30, called at
// quber_tpu/predictor.py:402 and :957), which the port ran as about ten
// plain torch launches with float64 moments.
//
// masks [B, N, H, W] uint8, valid [B, N] uint8 -> areas [B, N] f32, centers
// [B, N, 2] f32 (y, x), ok [B, N] uint8 = valid and area > 0. Invalid and
// empty instances get area 0 and centroid (0, 0).
//
// Bound on the H100: bytes, one read of every valid row. A block takes a
// chunk of one instance's row: each thread has four 16-byte loads in flight
// and sums the set pixels, their rows and their columns with dp4a on the
// packed bytes (16 pixels of one load lie in one image row, since W % 16 ==
// 0 in the vector variant). The sums are integers, reduced by warp shuffles
// and added with one 64-bit atomic per block and sum into scratch[B*N][4],
// which the launch function zeroes; integer sums are exact in any order, so
// the result is deterministic. The block that arrives last for its instance
// (a counter in scratch[..][3]) divides in double and rounds once to float,
// exactly what the plain version computes. Rows of invalid instances are
// never read.
// ---------------------------------------------------------------------------
constexpr int kStatThreads = 256;
constexpr int kStatLoadsVec = 4;      // 16-byte loads in flight a thread
constexpr int kStatLoadsScalar = 16;  // byte loads in flight a thread

template <bool VEC>
__global__ void __launch_bounds__(kStatThreads)
stats_kernel(const uint8_t* __restrict__ masks, const uint8_t* __restrict__ valid,
             u64* __restrict__ scratch, float* __restrict__ areas,
             float* __restrict__ centers, uint8_t* __restrict__ ok, int n, int h, int w) {
  constexpr int kLoads = VEC ? kStatLoadsVec : kStatLoadsScalar;
  __shared__ u64 s_red[kStatThreads / 32][3];

  const size_t bn = (size_t)blockIdx.z * n + blockIdx.y;
  if (!valid[bn]) {  // uniform across the block
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      areas[bn] = 0.0f;
      centers[2 * bn] = 0.0f;
      centers[2 * bn + 1] = 0.0f;
      ok[bn] = 0;
    }
    return;
  }
  const unsigned hw = (unsigned)h * (unsigned)w;
  const uint8_t* row = masks + bn * hw;
  const unsigned first = blockIdx.x * (kStatThreads * kLoads) + threadIdx.x;

  unsigned area = 0;
  u64 sum_y = 0;
  u64 sum_x = 0;
  if constexpr (VEC) {
    const unsigned units = hw / 16;
    uint4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const unsigned u = first + i * kStatThreads;
      v[i] = u < units ? __ldg(reinterpret_cast<const uint4*>(row) + u)
                       : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const unsigned p = (first + i * kStatThreads) * 16;
      const unsigned y = p / (unsigned)w;
      const unsigned x = p - y * (unsigned)w;
      const unsigned a = __vminu4(v[i].x, kOnes), b = __vminu4(v[i].y, kOnes);
      const unsigned c = __vminu4(v[i].z, kOnes), d = __vminu4(v[i].w, kOnes);
      unsigned cnt = __dp4a(a, kOnes, 0u);
      cnt = __dp4a(b, kOnes, cnt);
      cnt = __dp4a(c, kOnes, cnt);
      cnt = __dp4a(d, kOnes, cnt);
      unsigned col = __dp4a(a, 0x03020100u, 0u);  // sum of i over set pixel i
      col = __dp4a(b, 0x07060504u, col);
      col = __dp4a(c, 0x0b0a0908u, col);
      col = __dp4a(d, 0x0f0e0d0cu, col);
      area += cnt;
      sum_y += (u64)y * cnt;
      sum_x += (u64)x * cnt + col;
    }
  } else {
    uint8_t v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const unsigned p = first + i * kStatThreads;
      v[i] = p < hw ? row[p] : (uint8_t)0;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      if (v[i]) {
        const unsigned p = first + i * kStatThreads;
        const unsigned y = p / (unsigned)w;
        area += 1;
        sum_y += y;
        sum_x += p - y * (unsigned)w;
      }
    }
  }

  u64 sum_a = area;
  for (int d = 16; d > 0; d >>= 1) {
    sum_a += __shfl_down_sync(kFullMask, sum_a, d);
    sum_y += __shfl_down_sync(kFullMask, sum_y, d);
    sum_x += __shfl_down_sync(kFullMask, sum_x, d);
  }
  if ((threadIdx.x & 31) == 0) {
    s_red[threadIdx.x >> 5][0] = sum_a;
    s_red[threadIdx.x >> 5][1] = sum_y;
    s_red[threadIdx.x >> 5][2] = sum_x;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < kStatThreads / 32; ++i) {
    sum_a += s_red[i][0];
    sum_y += s_red[i][1];
    sum_x += s_red[i][2];
  }
  u64* acc = scratch + 4 * bn;
  if (sum_a) {
    atomicAdd(acc + 0, sum_a);
    atomicAdd(acc + 1, sum_y);
    atomicAdd(acc + 2, sum_x);
  }
  __threadfence();
  if (atomicAdd(acc + 3, (u64)1) != gridDim.x - 1) return;
  // the last block of this instance: every other block's sums are visible
  __threadfence();
  const u64 tot_a = *reinterpret_cast<volatile u64*>(acc + 0);
  const u64 tot_y = *reinterpret_cast<volatile u64*>(acc + 1);
  const u64 tot_x = *reinterpret_cast<volatile u64*>(acc + 2);
  const double denom = (double)(tot_a ? tot_a : (u64)1);
  areas[bn] = (float)tot_a;
  centers[2 * bn] = (float)((double)tot_y / denom);
  centers[2 * bn + 1] = (float)((double)tot_x / denom);
  ok[bn] = tot_a != 0;
}

// ---------------------------------------------------------------------------
// encode_initial_masks: replaces encode_initial_masks_pallas and its batched
// twin (quber_tpu/ops/pallas_kernels.py:154 and :252).
//
// masks [B, N, H, W] uint8, ok [B, N] uint8 (valid and area > 0), centers
// [B, N, 2] f32 float centroids (y, x) -> out [B, 3, H, W] f32:
//   out[0] = exp(-min_k d2_k / (2 sigma^2)) over ok instances whose window
//            |dy|, |dx| <= 3 sigma + 1 around the ROUNDED centroid holds the
//            pixel, 0 where none does;
//   out[1:3] = (cy - y, cx - x) / (H, W) (or / 1) to the FLOAT centroid of
//            the last-wins owner: the highest ok index whose mask covers
//            the pixel; 0 where none covers it.
//
// Bound on the H100: bytes. Every ok row of the stack is read once and 12
// bytes are written per pixel; the design has to keep enough of those bytes
// in flight and spend next to no issue slots on them.
//   * A block owns a 2-D tile of pixels (8 rows x 128 columns in the vector
//     variant) and first stages two lists in shared memory: the ok instances
//     in ascending order (float centroid and row index), and those of them
//     whose 63 x 63 window meets the tile. The test is on the tile's
//     bounding box, so the second list is a superset of the instances whose
//     window holds any pixel of the tile.
//   * Owner pass: 64 threads cover the tile with 16 pixels each, and the
//     block's four groups of 64 each take every fourth ok instance, four
//     16-byte loads in flight a thread. Entry j marks its pixels with j + 1
//     by a byte-lane multiply (bytes are 0/1 after a lane-wise min with 1,
//     and j + 1 <= 255 inside a chunk of 255 entries, so no lane carries),
//     and a lane-wise max keeps the highest: the last-wins owner. Chunks
//     ascend, so a later chunk's owner overwrites an earlier one's. Each
//     group leaves its owners in shared memory as 16-bit entry numbers.
//   * Pixel pass: each thread takes 4 pixels, the max of the four groups'
//     owners, the windowed min of d2 over the tile's short list only (about
//     two instances instead of all), and writes three float4.
// The scalar variant keeps the compacted table, the tile's list and the
// unrolled loads, with one pixel and one byte load a thread.
// ---------------------------------------------------------------------------
constexpr int kEncThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePx = kTileH * kTileW;
constexpr int kOwnerThreads = kTilePx / 16;           // cover the tile, 16 px each
constexpr int kSlices = kEncThreads / kOwnerThreads;  // instance slices of a block
constexpr int kChunk = 255;                           // entries whose j + 1 fits a byte
constexpr int kScalarTileH = 8;
constexpr int kScalarTileW = 32;

static_assert(kTilePx == 4 * kEncThreads, "the pixel pass takes 4 pixels a thread");
static_assert(kScalarTileH * kScalarTileW == kEncThreads, "one pixel a thread");

struct EncodeTables {
  float2* cen;     // [n_ok] float centroid (y, x) of compacted entry j
  uint16_t* idx;   // [n_ok] its row in the mask stack
  uint16_t* cull;  // [*n_cull] entries whose window meets the tile
  int n_ok;
  int n_cull;
};

// Stages the block's tables for the tile [y0, y0 + th) x [x0, x0 + tw).
__device__ __forceinline__ EncodeTables stage_instances(
    const uint8_t* __restrict__ ok, const float* __restrict__ centers, int n,
    unsigned char* smem_raw, int* s_wcnt, int* s_ncull, int y0, int x0, int th, int tw,
    float lim) {
  EncodeTables t;
  t.cen = reinterpret_cast<float2*>(smem_raw);
  t.idx = reinterpret_cast<uint16_t*>(t.cen + n);
  t.cull = t.idx + n;
  const float y_lo = (float)y0 - lim, y_hi = (float)(y0 + th - 1) + lim;
  const float x_lo = (float)x0 - lim, x_hi = (float)(x0 + tw - 1) + lim;
  if (threadIdx.x == 0) *s_ncull = 0;
  int n_ok = 0;
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    float cy = 0.0f, cx = 0.0f;
    bool flag = false;
    if (k < n) {
      flag = ok[k] != 0;
      cy = centers[2 * k];
      cx = centers[2 * k + 1];
    }
    const int slot = compact_slot(flag, n_ok, s_wcnt);
    if (slot >= 0) {
      t.cen[slot] = make_float2(cy, cx);
      t.idx[slot] = (uint16_t)k;
      const float ry = rintf(cy), rx = rintf(cx);
      if (ry >= y_lo && ry <= y_hi && rx >= x_lo && rx <= x_hi)
        t.cull[atomicAdd(s_ncull, 1)] = (uint16_t)slot;
    }
  }
  __syncthreads();
  t.n_ok = n_ok;
  t.n_cull = *s_ncull;
  return t;
}

// The three channels of PX pixels of row y from column x on: `owner[i]` is
// the 1-based compacted entry that owns pixel i, 0 for none.
template <int PX>
__device__ __forceinline__ void write_pixels(const EncodeTables& t, const int* owner,
                                             float* __restrict__ o, size_t hw, int y, int x,
                                             float lim, float two_s2, float sy, float sx) {
  const float fy = (float)y;
  float d2min[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) d2min[i] = INFINITY;
  for (int e = 0; e < t.n_cull; ++e) {
    const float2 c = t.cen[t.cull[e]];
    const float dy = __fsub_rn(fy, rintf(c.x));
    if (fabsf(dy) <= lim) {
      const float dy2 = __fmul_rn(dy, dy);
      const float rx = rintf(c.y);
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const float dx = __fsub_rn((float)(x + i), rx);
        if (fabsf(dx) <= lim)
          d2min[i] = fminf(d2min[i], __fadd_rn(dy2, __fmul_rn(dx, dx)));
      }
    }
  }
  float heat[PX], off_y[PX], off_x[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    heat[i] = isfinite(d2min[i]) ? expf(-d2min[i] / two_s2) : 0.0f;
    off_y[i] = 0.0f;
    off_x[i] = 0.0f;
    if (owner[i]) {
      const float2 c = t.cen[owner[i] - 1];
      off_y[i] = __fsub_rn(c.x, fy) / sy;
      off_x[i] = __fsub_rn(c.y, (float)(x + i)) / sx;
    }
  }
  if constexpr (PX == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(heat[0], heat[1], heat[2], heat[3]);
    *reinterpret_cast<float4*>(o + hw) = make_float4(off_y[0], off_y[1], off_y[2], off_y[3]);
    *reinterpret_cast<float4*>(o + 2 * hw) =
        make_float4(off_x[0], off_x[1], off_x[2], off_x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      o[i] = heat[i];
      o[hw + i] = off_y[i];
      o[2 * hw + i] = off_x[i];
    }
  }
}

// marks the set pixels of a 16-byte load with `tag` (1..255), keeping the max
__device__ __forceinline__ void fold_owner(uint4& acc, const uint4 v, unsigned tag) {
  acc.x = __vmaxu4(acc.x, __vminu4(v.x, kOnes) * tag);
  acc.y = __vmaxu4(acc.y, __vminu4(v.y, kOnes) * tag);
  acc.z = __vmaxu4(acc.z, __vminu4(v.z, kOnes) * tag);
  acc.w = __vmaxu4(acc.w, __vminu4(v.w, kOnes) * tag);
}

__global__ void __launch_bounds__(kEncThreads)
encode_kernel_vec(const uint8_t* __restrict__ masks, const uint8_t* __restrict__ ok,
                  const float* __restrict__ centers, float* __restrict__ out, int n, int h,
                  int w, float lim, float two_s2, float sy, float sx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) uint16_t s_own[kSlices][kTilePx];
  __shared__ int s_wcnt[kEncThreads / 32];
  __shared__ int s_ncull;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t hw = (size_t)h * w;
  const EncodeTables t =
      stage_instances(ok + (size_t)b * n, centers + (size_t)b * n * 2, n, smem_raw, s_wcnt,
                      &s_ncull, y0, x0, kTileH, kTileW, lim);

  {  // owner pass: 16 pixels a thread, every kSlices-th entry
    const int g = threadIdx.x % kOwnerThreads;
    const int slice = threadIdx.x / kOwnerThreads;
    const int r = g / (kTileW / 16);
    const int c = g % (kTileW / 16);
    const int y = y0 + r;
    const int x = x0 + 16 * c;
    const bool inside = y < h && x < w;
    const uint8_t* m = masks + (size_t)b * n * hw + (size_t)y * w + x;
    uint16_t* own = &s_own[slice][r * kTileW + 16 * c];
    int jb = 0;
    do {
      const int jend = min(jb + kChunk, t.n_ok);
      uint4 acc = make_uint4(0, 0, 0, 0);
      if (inside) {
        int j = jb + slice;
        for (; j + 3 * kSlices < jend; j += 4 * kSlices) {
          const uint4 v0 = __ldg(reinterpret_cast<const uint4*>(m + t.idx[j] * hw));
          const uint4 v1 =
              __ldg(reinterpret_cast<const uint4*>(m + t.idx[j + kSlices] * hw));
          const uint4 v2 =
              __ldg(reinterpret_cast<const uint4*>(m + t.idx[j + 2 * kSlices] * hw));
          const uint4 v3 =
              __ldg(reinterpret_cast<const uint4*>(m + t.idx[j + 3 * kSlices] * hw));
          fold_owner(acc, v0, j - jb + 1);
          fold_owner(acc, v1, j + kSlices - jb + 1);
          fold_owner(acc, v2, j + 2 * kSlices - jb + 1);
          fold_owner(acc, v3, j + 3 * kSlices - jb + 1);
        }
        for (; j < jend; j += kSlices)
          fold_owner(acc, __ldg(reinterpret_cast<const uint4*>(m + t.idx[j] * hw)),
                     j - jb + 1);
      }
      if (jb == 0) {  // bytes to 16-bit entries, two 16-byte stores
        uint4 lo, hi;
        lo.x = __byte_perm(acc.x, 0, 0x4140);
        lo.y = __byte_perm(acc.x, 0, 0x4342);
        lo.z = __byte_perm(acc.y, 0, 0x4140);
        lo.w = __byte_perm(acc.y, 0, 0x4342);
        hi.x = __byte_perm(acc.z, 0, 0x4140);
        hi.y = __byte_perm(acc.z, 0, 0x4342);
        hi.z = __byte_perm(acc.w, 0, 0x4140);
        hi.w = __byte_perm(acc.w, 0, 0x4342);
        reinterpret_cast<uint4*>(own)[0] = lo;
        reinterpret_cast<uint4*>(own)[1] = hi;
      } else {  // more than 255 ok instances: a later chunk's owner wins
        const unsigned words[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const unsigned tag = (words[i / 4] >> (8 * (i % 4))) & 0xffu;
          if (tag) own[i] = (uint16_t)(jb + tag);
        }
      }
      jb += kChunk;
    } while (jb < t.n_ok);
  }
  __syncthreads();

  // pixel pass: 4 pixels a thread
  const int r = threadIdx.x / (kTileW / 4);
  const int y = y0 + r;
  const int x = x0 + 4 * (threadIdx.x % (kTileW / 4));
  if (y >= h || x >= w) return;
  const int q = r * kTileW + (x - x0);
  uint2 packed = *reinterpret_cast<const uint2*>(&s_own[0][q]);
#pragma unroll
  for (int s = 1; s < kSlices; ++s) {
    const uint2 other = *reinterpret_cast<const uint2*>(&s_own[s][q]);
    packed.x = __vmaxu2(packed.x, other.x);
    packed.y = __vmaxu2(packed.y, other.y);
  }
  const int owner[4] = {(int)(packed.x & 0xffffu), (int)(packed.x >> 16),
                        (int)(packed.y & 0xffffu), (int)(packed.y >> 16)};
  write_pixels<4>(t, owner, out + (size_t)b * 3 * hw + (size_t)y * w + x, hw, y, x, lim,
                  two_s2, sy, sx);
}

__global__ void __launch_bounds__(kEncThreads)
encode_kernel_scalar(const uint8_t* __restrict__ masks, const uint8_t* __restrict__ ok,
                     const float* __restrict__ centers, float* __restrict__ out, int n,
                     int h, int w, float lim, float two_s2, float sy, float sx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_wcnt[kEncThreads / 32];
  __shared__ int s_ncull;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kScalarTileW;
  const int y0 = blockIdx.y * kScalarTileH;
  const size_t hw = (size_t)h * w;
  const EncodeTables t =
      stage_instances(ok + (size_t)b * n, centers + (size_t)b * n * 2, n, smem_raw, s_wcnt,
                      &s_ncull, y0, x0, kScalarTileH, kScalarTileW, lim);
  const int y = y0 + threadIdx.x / kScalarTileW;
  const int x = x0 + threadIdx.x % kScalarTileW;
  if (y >= h || x >= w) return;
  const uint8_t* m = masks + (size_t)b * n * hw + (size_t)y * w + x;

  int owner = 0;  // ascending scan: the last set entry wins
  int j = 0;
  for (; j + 3 < t.n_ok; j += 4) {
    const uint8_t v0 = m[t.idx[j] * hw];
    const uint8_t v1 = m[t.idx[j + 1] * hw];
    const uint8_t v2 = m[t.idx[j + 2] * hw];
    const uint8_t v3 = m[t.idx[j + 3] * hw];
    owner = v0 ? j + 1 : owner;
    owner = v1 ? j + 2 : owner;
    owner = v2 ? j + 3 : owner;
    owner = v3 ? j + 4 : owner;
  }
  for (; j < t.n_ok; ++j) owner = m[t.idx[j] * hw] ? j + 1 : owner;
  write_pixels<1>(t, &owner, out + (size_t)b * 3 * hw + (size_t)y * w + x, hw, y, x, lim,
                  two_s2, sy, sx);
}

// ---------------------------------------------------------------------------
// group_pixels: replaces group_pixels_pallas and its batched twin
// (quber_tpu/ops/pallas_kernels.py:37 and :98).
//
// centers [B, K, 2] int32 (y, x), valid [B, K] uint8, offsets [B, 2, H, W]
// f32 -> ids [B, H, W] int32, 1-based: argmin_k (y + dy - cy_k)^2 +
// (x + dx - cx_k)^2 over the valid k, the first index on a tie; a pixel with
// no valid centre gets id 1, as argmin over an all-+inf row gives index 0.
//
// Bound on the H100: bytes at small K (8 read and 4 written per pixel),
// the SMs' issue rate at K = 200. The rounding of dy^2 + dx^2 is pinned (two
// subtractions, two products, one sum, no FMA: an FMA flips near-ties
// against the plain version), so a (pixel, centre) pair costs those five
// plus a compare and two selects; what the design can remove is everything
// around them.
//   * The valid centres are compacted in ascending order into shared memory
//     as float2, so the scan has no validity branch and one 8-byte broadcast
//     load a centre; the strict '<' over ascending entries is the
//     first-index tie-break, and the winner's entry is mapped back to its
//     index once a pixel.
//   * A thread takes 4 consecutive pixels (float4 loads of both offset
//     planes, one int4 store): each centre's load and the loop's overhead
//     serve four independent distance chains. Blocks of 128 threads keep the
//     last wave of blocks short at one frame.
// Measured and not kept: a scan that takes four centres a step (their min,
// one compare and two selects a step, the winner found again at the end) is
// 10% faster at K = 200 and 2-6% slower at K = 32, the path that serving
// takes; loading the offsets before the table is staged, blocks of 256
// threads and a deeper unroll were all slower.
// The scalar variant is the same kernel with one pixel a thread.
// ---------------------------------------------------------------------------
constexpr int kGroupThreads = 128;

template <int PX>
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(const int32_t* __restrict__ centers, const uint8_t* __restrict__ valid,
             const float* __restrict__ offsets, int32_t* __restrict__ ids, int k_total,
             int h, int w) {
  static_assert(PX == 1 || PX == 4, "one pixel, or four with 16-byte accesses");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_wcnt[kGroupThreads / 32];
  float2* s_cen = reinterpret_cast<float2*>(smem_raw);
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_cen + k_total);

  const int b = blockIdx.y;
  const unsigned hw = (unsigned)h * (unsigned)w;
  const unsigned p = (blockIdx.x * kGroupThreads + threadIdx.x) * PX;
  int n_valid = 0;
  for (int k0 = 0; k0 < k_total; k0 += kGroupThreads) {
    const int k = k0 + threadIdx.x;
    int cy = 0, cx = 0;
    bool flag = false;
    if (k < k_total) {
      flag = valid[(size_t)b * k_total + k] != 0;
      cy = centers[((size_t)b * k_total + k) * 2];
      cx = centers[((size_t)b * k_total + k) * 2 + 1];
    }
    const int slot = compact_slot(flag, n_valid, s_wcnt);
    if (slot >= 0) {
      s_cen[slot] = make_float2((float)cy, (float)cx);
      s_idx[slot] = (uint16_t)k;
    }
  }
  __syncthreads();
  if (p >= hw) return;

  const float* off = offsets + (size_t)b * 2 * hw + p;
  float oy[PX], ox[PX];
  if constexpr (PX == 4) {
    const float4 vy = __ldg(reinterpret_cast<const float4*>(off));
    const float4 vx = __ldg(reinterpret_cast<const float4*>(off + hw));
    oy[0] = vy.x, oy[1] = vy.y, oy[2] = vy.z, oy[3] = vy.w;
    ox[0] = vx.x, ox[1] = vx.y, ox[2] = vx.z, ox[3] = vx.w;
  } else {
    oy[0] = off[0];
    ox[0] = off[hw];
  }
  float ly[PX], lx[PX], best[PX];
  int arg[PX];
  unsigned y = p / (unsigned)w;
  unsigned x = p - y * (unsigned)w;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    ly[i] = __fadd_rn((float)y, oy[i]);
    lx[i] = __fadd_rn((float)x, ox[i]);
    best[i] = INFINITY;
    arg[i] = -1;  // nothing below +inf yet: id 1
    if (++x == (unsigned)w) {
      x = 0;
      ++y;
    }
  }

#pragma unroll 4
  for (int j = 0; j < n_valid; ++j) {
    const float2 c = s_cen[j];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const float dy = __fsub_rn(ly[i], c.x);
      const float dx = __fsub_rn(lx[i], c.y);
      const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
      if (d2 < best[i]) {
        best[i] = d2;
        arg[i] = j;
      }
    }
  }

  int id[PX];
#pragma unroll
  for (int i = 0; i < PX; ++i) id[i] = arg[i] >= 0 ? (int)s_idx[arg[i]] + 1 : 1;
  int32_t* dst = ids + (size_t)b * hw + p;
  if constexpr (PX == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(id[0], id[1], id[2], id[3]);
  } else {
#pragma unroll
    for (int i = 0; i < PX; ++i) dst[i] = id[i];
  }
}

// Nothing: its time through the same launch path is the floor of the
// measurement (launch, event pair), which no kernel's time can go below.
__global__ void empty_kernel() {}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

bool frame_too_large(int h, int w) { return (long long)h * w >= (1ll << 31); }

unsigned ceil_div(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

// scratch: [B * N * 4] 64-bit words, zeroed here.
extern "C" int quber_instance_stats(const void* masks, const void* valid, void* scratch,
                                    void* areas, void* centers, void* ok, int b, int n,
                                    int h, int w, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (frame_too_large(h, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)b * n * 4 * sizeof(u64), s);
  if (err != cudaSuccess) return (int)err;
  const long long hw = (long long)h * w;
  if (w % 16 == 0 && aligned16(masks)) {
    const dim3 grid(ceil_div(hw, kStatThreads * kStatLoadsVec * 16), (unsigned)n, (unsigned)b);
    stats_kernel<true><<<grid, kStatThreads, 0, s>>>(
        (const uint8_t*)masks, (const uint8_t*)valid, (u64*)scratch, (float*)areas,
        (float*)centers, (uint8_t*)ok, n, h, w);
  } else {
    const dim3 grid(ceil_div(hw, kStatThreads * kStatLoadsScalar), (unsigned)n, (unsigned)b);
    stats_kernel<false><<<grid, kStatThreads, 0, s>>>(
        (const uint8_t*)masks, (const uint8_t*)valid, (u64*)scratch, (float*)areas,
        (float*)centers, (uint8_t*)ok, n, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" int quber_encode_initial_masks(const void* masks, const void* ok,
                                          const void* centers, void* out,
                                          int b, int n, int h, int w, int sigma,
                                          int normalize, void* stream) {
  if (b == 0) return 0;
  if (frame_too_large(h, w)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * (sizeof(float2) + 2 * sizeof(uint16_t));
  const float lim = (float)(3 * sigma + 1);
  const float two_s2 = 2.0f * (float)sigma * (float)sigma;
  const float sy = normalize ? (float)h : 1.0f;
  const float sx = normalize ? (float)w : 1.0f;
  cudaStream_t s = (cudaStream_t)stream;
  if (w % 16 == 0 && aligned16(masks) && aligned16(out)) {
    const dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), (unsigned)b);
    encode_kernel_vec<<<grid, kEncThreads, smem, s>>>(
        (const uint8_t*)masks, (const uint8_t*)ok, (const float*)centers, (float*)out, n,
        h, w, lim, two_s2, sy, sx);
  } else {
    const dim3 grid(ceil_div(w, kScalarTileW), ceil_div(h, kScalarTileH), (unsigned)b);
    encode_kernel_scalar<<<grid, kEncThreads, smem, s>>>(
        (const uint8_t*)masks, (const uint8_t*)ok, (const float*)centers, (float*)out, n,
        h, w, lim, two_s2, sy, sx);
  }
  return (int)cudaGetLastError();
}

extern "C" int quber_group_pixels(const void* centers, const void* valid,
                                  const void* offsets, void* ids, int b, int k,
                                  int h, int w, void* stream) {
  if (b == 0) return 0;
  if (frame_too_large(h, w)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * (sizeof(float2) + sizeof(uint16_t));
  const long long hw = (long long)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  if (hw % 4 == 0 && aligned16(offsets) && aligned16(ids)) {
    const dim3 grid(ceil_div(hw, kGroupThreads * 4), (unsigned)b);
    group_kernel<4><<<grid, kGroupThreads, smem, s>>>(
        (const int32_t*)centers, (const uint8_t*)valid, (const float*)offsets,
        (int32_t*)ids, k, h, w);
  } else {
    const dim3 grid(ceil_div(hw, kGroupThreads), (unsigned)b);
    group_kernel<1><<<grid, kGroupThreads, smem, s>>>(
        (const int32_t*)centers, (const uint8_t*)valid, (const float*)offsets,
        (int32_t*)ids, k, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" int quber_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
