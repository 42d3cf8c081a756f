"""The port's OpenCV-free readers and image operations against the calls
they replace: data/png.py against imageio and cv2.imread, and
ops/preprocess.py against the JAX package's host functions and OpenCV.

Tolerances: PNG decoding, nearest and bilinear resizing (OpenCV's uint8
fixed point), depth normalisation and Telea inpainting exact.
"""

import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from quber_tpu.ops import preprocess as jpre
from quber_tpu_torch.data import png
from quber_tpu_torch.data.synthetic import render_scene
from quber_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(2)


def _image(rng, kind, h, w):
    ys, xs = np.mgrid[:h, :w]
    smooth = 120 + 60 * np.sin(ys / 5.0) + 50 * np.cos(xs / 7.0)
    noisy = smooth + rng.randn(h, w) * 15
    if kind == "grey":
        return np.clip(noisy, 0, 255).astype(np.uint8)
    if kind == "u16":
        return (smooth * 40 + rng.randint(0, 500, (h, w))).astype(np.uint16)
    chans = [np.clip(noisy + 30 * c, 0, 255) for c in range(3)]
    if kind == "rgba":
        chans.append(rng.randint(0, 256, (h, w)))
    return np.stack(chans, -1).astype(np.uint8)


KINDS = ["grey", "rgb", "rgba", "u16"]
SIZES = [(37, 53), (1, 1), (64, 3), (5, 129)]


def _filtered_png(path, img):
    """A PNG whose row y uses filter y % 5 (None, Sub, Up, Average, Paeth)."""
    if img.dtype == np.uint16:
        color, depth, body = 0, 16, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        bpp = 2
    else:
        color = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}[img.ndim]
        depth, body, bpp = 8, img.reshape(img.shape[0], -1), 1 if img.ndim == 2 else img.shape[2]
    raw = bytearray()
    prev = np.zeros(body.shape[1], np.int32)
    for y, row in enumerate(body.astype(np.int32)):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES)
def test_png_reader_matches_imageio(tmp_path, kind, size):
    rng = np.random.RandomState(hash((kind, size)) % 2**31)
    img = _image(rng, kind, *size)
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)  # Pillow picks a filter per row
    got = png.imread(path)
    assert got.dtype == img.dtype and np.array_equal(got, np.asarray(imageio.imread(path)))
    _filtered_png(path, img)  # every filter type, one per row
    want = np.asarray(imageio.imread(path))
    assert np.array_equal(want, img)
    assert np.array_equal(png.imread(path), want)


@pytest.mark.parametrize("kind", KINDS)
def test_png_bgr_matches_cv2_imread(tmp_path, kind):
    img = _image(np.random.RandomState(3), kind, 31, 45)
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    got = png.imread(path, bgr=True)
    want = cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_png_writer_reads_back_in_imageio(tmp_path, kind):
    img = _image(np.random.RandomState(4), kind, 23, 41)
    path = str(tmp_path / "a.png")
    png.imwrite(path, img)
    assert np.array_equal(np.asarray(imageio.imread(path)), img)
    assert np.array_equal(png.imread(path), img)


def test_png_rejects_other_formats(tmp_path):
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, np.zeros((4, 4, 2), np.uint8))  # grey + alpha
    with pytest.raises(ValueError):
        png.imread(path)
    with pytest.raises(ValueError):
        png.imwrite(path, np.zeros((4, 4), np.float32))


RESIZES = [((480, 640), (240, 320)), ((480, 640), (64, 96)), ((64, 96), (480, 640)),
           ((37, 53), (100, 17)), ((359, 477), (480, 640)), ((480, 640), (361, 251)),
           ((7, 9), (7, 9))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_nearest_matches_cv2(src, dst):
    rng = np.random.RandomState(5)
    for img in (rng.randint(0, 256, src).astype(np.uint8),
                rng.randint(0, 256, src + (3,)).astype(np.uint8),
                rng.randint(-5, 300, src).astype(np.int32)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
        got = tpre.resize_nearest(img, dst)
        assert got.dtype == img.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_linear_within_one_level_of_cv2(src, dst):
    rng = np.random.RandomState(6)
    ys, xs = np.mgrid[:src[0], :src[1]]
    smooth = 128 + 100 * np.sin(ys / 3.0) * np.cos(xs / 4.0)
    for img in (np.clip(smooth, 0, 255).astype(np.uint8),
                rng.randint(0, 256, src + (3,)).astype(np.uint8)):
        want = cv2.resize(img, dst[::-1])
        got = tpre.resize_linear(img, dst)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want)


def test_normalize_and_standardize_match_jax():
    rng = np.random.RandomState(7)
    depth = rng.randint(0, 2000, (48, 64)).astype(np.uint16)
    assert np.array_equal(tpre.normalize_depth(depth), jpre.normalize_depth(depth))
    metres = rng.uniform(0, 2, (48, 64)).astype(np.float32)
    assert np.array_equal(tpre.normalize_depth(metres, 0.25, 1.5),
                          jpre.normalize_depth(metres, 0.25, 1.5))
    rgb = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    assert np.array_equal(tpre.standardize_image(rgb), jpre.standardize_image(rgb))


def _rendered_depth(seed, h, w, dropout):
    rng = np.random.RandomState(seed)
    _, depth, _ = render_scene(rng, h, w, depth_range=(250, 1500), dropout_frac=dropout)
    return tpre.normalize_depth(np.round(depth).astype(np.uint16))


@pytest.mark.parametrize("seed", [1000, 1001])
def test_inpaint_depth_matches_cv2_telea_on_dropout(seed):
    """The anchor protocol's depth: 0.2% of the pixels dropped (~600 holes)."""
    depth = _rendered_depth(seed, 480, 640, 0.002)
    holes = depth == 0
    assert holes[..., 0].sum() > 300
    got = tpre.inpaint_depth(depth)
    want = jpre.inpaint_depth(depth)
    assert np.array_equal(got[~holes], depth[~holes])
    assert np.array_equal(got, want)


def test_inpaint_depth_matches_cv2_telea_on_clustered_holes():
    """Discs, strips on the image border and a corner: the border clamping
    and one-sided gradients of OpenCV's implementation."""
    depth = _rendered_depth(5, 120, 160, 0.0)
    rng = np.random.RandomState(5)
    ys, xs = np.mgrid[:120, :160]
    for _ in range(6):
        cy, cx, r = rng.randint(0, 120), rng.randint(0, 160), rng.randint(2, 9)
        depth[(ys - cy) ** 2 + (xs - cx) ** 2 <= r * r] = 0
    depth[:3, 40:60] = 0
    depth[50:60, :4] = 0
    depth[-2:, -3:] = 0
    got = tpre.inpaint_depth(depth)
    assert np.array_equal(got, jpre.inpaint_depth(depth))


@pytest.mark.parametrize("channels", [1, 3])
def test_inpaint_telea_matches_cv2_on_flat_and_textured_images(channels):
    """Flat regions put the fill on a rounding tie (x.5), so they show any
    departure from OpenCV's float32 arithmetic."""
    rng = np.random.RandomState(9)
    ys, xs = np.mgrid[:40, :60]
    textured = (100 + 40 * np.sin(ys / 6.0) + 30 * np.cos(xs / 9.0)
                + rng.randint(0, 20, (40, 60))).astype(np.uint8)
    for img in (np.full((40, 60), 77, np.uint8), textured):
        if channels == 3:
            img = np.stack([img, img // 2, 255 - img], -1)
        mask = np.zeros((40, 60), np.uint8)
        mask[0:3, 25:28] = mask[0:2, 0:2] = mask[20:25, 30:33] = mask[-1, 10] = 1
        mask[(rng.rand(40, 60) < 0.02)] = 1
        want = cv2.inpaint(img, mask, 3, cv2.INPAINT_TELEA)
        assert np.array_equal(tpre.inpaint_telea(img, mask, 3).reshape(want.shape), want)


def test_inpaint_depth_takes_factor_one_only():
    with pytest.raises(NotImplementedError):
        tpre.inpaint_depth(np.zeros((8, 8, 3), np.uint8), factor=2)
