"""Wrappers of the hand-written CUDA kernels (ops/csrc/kernels.cu).

Counterpart of quber_tpu/ops/pallas_kernels.py: a single-frame and a
batched wrapper for each of the two kernels, the batched one launching
once for the whole batch (grid.y = B). Each wrapper takes its
plain torch version for tensors on the CPU, and for CUDA tensors launches
its kernel or raises: there is no fallback. Each counts its kernel
launches in `<wrapper>.launches`, so a run can show that its path went
through the kernels.

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


def _launch_encode(masks, ok, centers, sigma, normalize) -> torch.Tensor:
    """Checks and launches encode_kernel over masks [B, N, H, W] bool, ok
    [B, N] bool, centers [B, N, 2] f32 -> [B, 3, H, W] f32."""
    b, n, h, w = masks.shape
    if n > _MAX_INSTANCES:
        raise ValueError(f"at most {_MAX_INSTANCES} instances, got {n}")
    dev = masks.device
    _check("masks", masks, torch.bool, (b, n, h, w), dev)
    _check("ok", ok, torch.bool, (b, n), dev)
    _check("centers", centers, torch.float32, (b, n, 2), dev)
    lib = load_library()
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quber_encode_initial_masks(
        masks.data_ptr(), ok.data_ptr(), centers.data_ptr(), out.data_ptr(),
        b, n, h, w, int(sigma), int(bool(normalize)), stream)
    _raise_on(err, "encode_initial_masks")
    return out


def _launch_group(centers, valid, offsets) -> torch.Tensor:
    """Checks and launches group_kernel over centers [B, K, 2] int32, valid
    [B, K] bool, offsets [B, 2, H, W] f32 -> ids [B, H, W] int32."""
    b, k = centers.shape[0], centers.shape[1]
    h, w = offsets.shape[2], offsets.shape[3]
    if k > _MAX_CENTERS:
        raise ValueError(f"at most {_MAX_CENTERS} centres, got {k}")
    dev = offsets.device
    _check("centers", centers, torch.int32, (b, k, 2), dev)
    _check("valid", valid, torch.bool, (b, k), dev)
    _check("offsets", offsets, torch.float32, (b, 2, h, w), dev)
    lib = load_library()
    ids = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.quber_group_pixels(centers.data_ptr(), valid.data_ptr(),
                                 offsets.data_ptr(), ids.data_ptr(), b, k, h, w, stream)
    _raise_on(err, "group_pixels")
    return ids


def encode_initial_masks(masks: torch.Tensor, ok: torch.Tensor, centers: torch.Tensor,
                         sigma: int = 10, normalize: bool = True) -> torch.Tensor:
    """masks [N, H, W] bool, ok [N] bool (valid and area > 0), centers [N, 2]
    f32 -> [3, H, W] f32. Replaces encode_initial_masks_pallas; the plain
    version is ops.encoding.encode_from_stats."""
    if masks.device.type == "cpu":
        return encoding.encode_from_stats(masks, ok, centers, sigma, normalize)
    out = _launch_encode(masks[None], ok[None], centers[None], sigma, normalize)[0]
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
    ids = _launch_group(centers[None], valid[None], offsets[None])[0]
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
    out = _launch_encode(masks, ok, centers, sigma, normalize)
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
    ids = _launch_group(centers, valid, offsets)
    group_pixels_batched.launches += 1
    return ids


group_pixels_batched.launches = 0


def reset_launch_counts() -> None:
    encode_initial_masks.launches = 0
    group_pixels.launches = 0
    encode_initial_masks_batched.launches = 0
    group_pixels_batched.launches = 0
