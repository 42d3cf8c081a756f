"""Wrappers of the hand-written CUDA kernels (ops/csrc/kernels.cu).

Counterpart of quber_tpu/ops/pallas_kernels.py: a single-frame and a
batched wrapper for the encode and the group kernel, the batched one
launching once for the whole batch, and `instance_stats`, the hand kernel
of the encode stage's areas and centroids (XLA reductions in the JAX
package), for a frame or a batch. The library holds a vector variant
(16-byte loads and stores) and a scalar variant of each kernel; its launch
functions take the vector one where the frame's width and the pointers'
alignment allow it, so every contiguous tensor of the right type is served
by a kernel.
Each wrapper takes its plain torch version for tensors on the CPU, and for
CUDA tensors launches its kernel or raises: there is no fallback. Each
counts its kernel launches in `<wrapper>.launches`, so a run can show that
its path went through the kernels.

The kernels are built at first use from the sources in the checkout with
  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
       -shared -Xcompiler -fPIC -o build/kernels/libquber_kernels_<hash>.so
into `build/kernels/` at the root of the repository, and loaded with
ctypes. `<hash>` is that of the source and flags, so an edited source is
rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from quber_tpu_torch.ops import encoding, grouping

_SRC = Path(__file__).resolve().parent / "csrc" / "kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
# shared-memory tables must fit the 48 KB a block gets without opting in
_MAX_INSTANCES = 2048
_MAX_CENTERS = 4096

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libquber_kernels_{tag}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quber_encode_initial_masks.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.quber_encode_initial_masks.restype = i
    lib.quber_group_pixels.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.quber_group_pixels.restype = i
    lib.quber_instance_stats.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.quber_instance_stats.restype = i
    lib.quber_empty_launch.argtypes = [p]
    lib.quber_empty_launch.restype = i
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on one CUDA device or the CPU, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _lead(t, trailing: int, batched: bool | None) -> tuple:
    """The leading (batch) dimensions of `t` before its last `trailing`: none
    for a frame, one for a batch, any number where `batched` is None."""
    n_lead = t.dim() - trailing
    if n_lead < 0 or (batched is not None and n_lead != int(batched)):
        raise ValueError(f"expected {'any' if batched is None else int(batched)} leading "
                         f"dimensions before the last {trailing}, got shape {tuple(t.shape)}")
    return tuple(t.shape[:n_lead])


# The launch helpers hand the kernels a frame as a batch of one through the
# same pointers, and allocate the outputs in the caller's shape: no views.

def _launch_encode(masks, ok, centers, sigma, normalize, batched) -> torch.Tensor:
    """Checks and launches encode_kernel over masks [(B,) N, H, W] bool, ok
    [(B,) N] bool, centers [(B,) N, 2] f32 -> [(B,) 3, H, W] f32."""
    lead = _lead(masks, 3, batched)
    n, h, w = masks.shape[-3:]
    if n > _MAX_INSTANCES:
        raise ValueError(f"at most {_MAX_INSTANCES} instances, got {n}")
    dev = masks.device
    _check("masks", masks, torch.bool, (*lead, n, h, w), dev)
    _check("ok", ok, torch.bool, (*lead, n), dev)
    _check("centers", centers, torch.float32, (*lead, n, 2), dev)
    lib = load_library()
    out = torch.empty((*lead, 3, h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quber_encode_initial_masks(
        masks.data_ptr(), ok.data_ptr(), centers.data_ptr(), out.data_ptr(),
        math.prod(lead), n, h, w, int(sigma), int(bool(normalize)), stream)
    _raise_on(err, "encode_initial_masks")
    return out


def _launch_stats(masks, valid):
    """Checks and launches stats_kernel over masks [..., N, H, W] bool, valid
    [..., N] bool -> areas [..., N] f32, centers [..., N, 2] f32, ok [..., N]
    bool."""
    lead = _lead(masks, 3, None)
    n, h, w = masks.shape[-3:]
    if n > _MAX_INSTANCES:
        raise ValueError(f"at most {_MAX_INSTANCES} instances, got {n}")
    dev = masks.device
    _check("masks", masks, torch.bool, (*lead, n, h, w), dev)
    _check("valid", valid, torch.bool, (*lead, n), dev)
    lib = load_library()
    b = math.prod(lead)
    areas = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    centers = torch.empty((*lead, n, 2), dtype=torch.float32, device=dev)
    ok = torch.empty((*lead, n), dtype=torch.bool, device=dev)
    # the kernel's 64-bit sums, zeroed by the launch function
    scratch = torch.empty((b * n, 4), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quber_instance_stats(
        masks.data_ptr(), valid.data_ptr(), scratch.data_ptr(), areas.data_ptr(),
        centers.data_ptr(), ok.data_ptr(), b, n, h, w, stream)
    _raise_on(err, "instance_stats")
    return areas, centers, ok


def _launch_group(centers, valid, offsets, batched) -> torch.Tensor:
    """Checks and launches group_kernel over centers [(B,) K, 2] int32, valid
    [(B,) K] bool, offsets [(B,) 2, H, W] f32 -> ids [(B,) H, W] int32."""
    lead = _lead(offsets, 3, batched)
    h, w = offsets.shape[-2:]
    k = centers.shape[-2] if centers.dim() >= 2 else -1
    if k > _MAX_CENTERS:
        raise ValueError(f"at most {_MAX_CENTERS} centres, got {k}")
    dev = offsets.device
    _check("centers", centers, torch.int32, (*lead, k, 2), dev)
    _check("valid", valid, torch.bool, (*lead, k), dev)
    _check("offsets", offsets, torch.float32, (*lead, 2, h, w), dev)
    lib = load_library()
    ids = torch.empty((*lead, h, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quber_group_pixels(centers.data_ptr(), valid.data_ptr(), offsets.data_ptr(),
                                 ids.data_ptr(), math.prod(lead), k, h, w, stream)
    _raise_on(err, "group_pixels")
    return ids


def instance_stats(masks: torch.Tensor, valid: torch.Tensor | None = None,
                   return_ok: bool = False):
    """masks [..., N, H, W] bool (a frame or a batch), valid [..., N] bool or
    None -> (areas [..., N] f32, centers [..., N, 2] f32), and with
    `return_ok` also ok = valid & (areas > 0), which the kernel writes in
    the same pass. Replaces the JAX package's XLA instance_stats on the
    card; the plain version is ops.encoding.instance_stats, whose exact
    integer sums and float64 division the kernel repeats bit for bit."""
    if valid is None:
        valid = torch.ones(masks.shape[:-2], dtype=torch.bool, device=masks.device)
    if masks.device.type == "cpu":
        areas, centers = encoding.instance_stats(masks, valid)
        return (areas, centers, valid & (areas > 0)) if return_ok else (areas, centers)
    areas, centers, ok = _launch_stats(masks, valid)
    instance_stats.launches += 1
    return (areas, centers, ok) if return_ok else (areas, centers)


instance_stats.launches = 0


def encode_initial_masks(masks: torch.Tensor, ok: torch.Tensor, centers: torch.Tensor,
                         sigma: int = 10, normalize: bool = True) -> torch.Tensor:
    """masks [N, H, W] bool, ok [N] bool (valid and area > 0), centers [N, 2]
    f32 -> [3, H, W] f32. Replaces encode_initial_masks_pallas; the plain
    version is ops.encoding.encode_from_stats."""
    if masks.device.type == "cpu":
        return encoding.encode_from_stats(masks, ok, centers, sigma, normalize)
    out = _launch_encode(masks, ok, centers, sigma, normalize, batched=False)
    encode_initial_masks.launches += 1
    return out


encode_initial_masks.launches = 0


def group_pixels(centers: torch.Tensor, valid: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """centers [K, 2] int32 (y, x), valid [K] bool, offsets [2, H, W] f32 ->
    1-based ids [H, W] int32. Replaces group_pixels_pallas; the plain version
    is ops.grouping.group_pixels."""
    if offsets.device.type == "cpu":
        return grouping.group_pixels(centers, valid, offsets)
    ids = _launch_group(centers, valid, offsets, batched=False)
    group_pixels.launches += 1
    return ids


group_pixels.launches = 0


def encode_initial_masks_batched(masks: torch.Tensor, ok: torch.Tensor,
                                 centers: torch.Tensor, sigma: int = 10,
                                 normalize: bool = True) -> torch.Tensor:
    """masks [B, N, H, W] bool, ok [B, N] bool, centers [B, N, 2] f32 ->
    [B, 3, H, W] f32, one launch for the batch (grid.y = B). Replaces
    encode_initial_masks_pallas_batched; the plain version is
    ops.encoding.encode_from_stats_batched."""
    if masks.device.type == "cpu":
        return encoding.encode_from_stats_batched(masks, ok, centers, sigma, normalize)
    out = _launch_encode(masks, ok, centers, sigma, normalize, batched=True)
    encode_initial_masks_batched.launches += 1
    return out


encode_initial_masks_batched.launches = 0


def group_pixels_batched(centers: torch.Tensor, valid: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """centers [B, K, 2] int32 (y, x), valid [B, K] bool, offsets [B, 2, H, W]
    f32 -> 1-based ids [B, H, W] int32, one launch for the batch (grid.y =
    B). Replaces group_pixels_pallas_batched; the plain version is
    ops.grouping.group_pixels_batched."""
    if offsets.device.type == "cpu":
        return grouping.group_pixels_batched(centers, valid, offsets)
    ids = _launch_group(centers, valid, offsets, batched=True)
    group_pixels_batched.launches += 1
    return ids


group_pixels_batched.launches = 0


def empty_launch(device) -> None:
    """Launches a kernel that does nothing on `device`'s current stream: timed
    like a kernel, it gives the floor of the measurement."""
    dev = torch.device(device)
    _raise_on(load_library().quber_empty_launch(torch.cuda.current_stream(dev).cuda_stream),
              "empty")


def reset_launch_counts() -> None:
    instance_stats.launches = 0
    encode_initial_masks.launches = 0
    group_pixels.launches = 0
    encode_initial_masks_batched.launches = 0
    group_pixels_batched.launches = 0
