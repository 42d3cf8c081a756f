"""Training from files: the port's loaders, OpenCV copies, augmentation,
error maps, mappers and worker loader against quber_tpu (and cv2) on a
UOAIS-Sim-layout set the test writes from a seed.

Tolerances: the loaders' records equal; the OpenCV copies equal to cv2 on
integer outputs, warpAffine INTER_LINEAR on uint8 within one grey level on
at most 0.1% of the pixels, the float32 GaussianBlur within 1e-5, the float32
INTER_CUBIC resize within 2.5e-6 (OpenCV 5.0's float32 order is not
reproduced); mapper targets exact, center / offset / offset_enc within 1e-5;
with SSD colour and Perlin on, colour within one grey level, depth within
1e-3, targets exact and the same draws consumed; PackedMapper bytes equal
with the augmentation off; the same multi-scale bucket sequence; the worker
loader's batches equal to the in-process iterator's with the augmentation
off.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from quber_tpu.config import TrainConfig as JTrainConfig
from quber_tpu.models.mask_refiner import MaskRefinerConfig as JConfig
from quber_tpu_torch.config import TrainConfig
from quber_tpu_torch.data import augmentation as TA
from quber_tpu_torch.data import datasets as TD
from quber_tpu_torch.data import eee as TE
from quber_tpu_torch.data import mappers as TM
from quber_tpu_torch.data import perlin as TPerlin
from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
from quber_tpu_torch.data.make_uoais_sim import make as make_uoais
from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
from quber_tpu_torch.ops import imgproc
from quber_tpu_torch.train.device_targets import PackedMapper

FRAME_H, FRAME_W = 60, 80  # the files; the mappers resize to the model's 48x64
H, W = 48, 64
TARGET_EXACT = ["sem_seg", "sem_seg_weights", "center_weights", "offset_weights",
                "eee_mask", "eee_boundary"]
TARGET_ATOL = {"center": 1e-5, "offset": 1e-5, "offset_enc": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Six rendered scenes as a UOAIS-Sim panoptic set, error maps stored."""
    tmp = tmp_path_factory.mktemp("uoais")
    make_dataset(["--out", str(tmp / "osd"), "--n", "6", "--height", str(FRAME_H),
                  "--width", str(FRAME_W), "--seed", "3", "--depth-range", "2500", "6000"])
    make_uoais(str(tmp / "osd"), str(tmp / "root"), felzenszwalb=False)
    return str(tmp / "root")


def _records(root):
    from quber_tpu.data import datasets as JD

    TD.register_standard_datasets(root)
    JD.register_standard_datasets(root)
    return TD.get_dataset("uoais_sim_train_panoptic"), JD.get_dataset("uoais_sim_train_panoptic")


def _configs(**train):
    model = dict(height=H, width=W)
    return (MaskRefinerConfig(**model), TrainConfig(**train),
            JConfig(**model), JTrainConfig(**train))


# ---------------------------------------------------------------------------
# loaders and readers
# ---------------------------------------------------------------------------

def test_loaders_give_the_reference_records(data_root, tmp_path):
    from quber_tpu.data import datasets as JD

    got, want = _records(data_root)
    assert len(got) == 6 and got == want
    assert all(k in got[0] for k in TD.EEE_KEYS) and got[0]["perturbed_segmentation"]
    assert set(TD.DATASET_REGISTRY) >= set(JD.DATASET_REGISTRY)
    inst = os.path.join(data_root, "UOAIS-Sim", "annotations", "coco_anns_uoais_sim_train.json")
    img_root = os.path.join(data_root, "UOAIS-Sim", "train")
    assert TD.load_perturbed_instance_json(inst, img_root) == \
        JD.load_perturbed_instance_json(inst, img_root)
    pan = np.random.RandomState(0).randint(0, 256, (5, 7, 3))
    assert np.array_equal(TD.rgb2id(pan), JD.rgb2id(pan))
    assert np.array_equal(TD.rgb2id(TD.id2rgb(TD.rgb2id(pan))), TD.rgb2id(pan))


def test_read_image_is_cv2_imread_and_refuses_jpeg(tmp_path):
    rng = np.random.RandomState(1)
    for name, img in (("grey.png", rng.randint(0, 256, (9, 11), np.uint8)),
                      ("rgba.png", rng.randint(0, 256, (9, 11, 4), np.uint8)),
                      ("rgb.png", rng.randint(0, 256, (9, 11, 3), np.uint8)),
                      ("depth.png", rng.randint(0, 65535, (9, 11)).astype(np.uint16))):
        path = str(tmp_path / name)
        cv2.imwrite(path, img)
        assert np.array_equal(TD.read_image(path, bgr=True), cv2.imread(path)), name
        assert np.array_equal(TD.read_image(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)[
            ..., [2, 1, 0, 3][:img.shape[2]] if img.ndim == 3 else slice(None)]), name
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, rng.randint(0, 256, (9, 11, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="item 11d"):
        TD.read_image(jpg, bgr=True)


# ---------------------------------------------------------------------------
# the OpenCV copies
# ---------------------------------------------------------------------------

def _cv2_color_hsv_runs_avx2() -> bool:
    """Whether cv2 runs the AVX2 build of its color_hsv code, whose lane
    widths ops/imgproc's colour copies follow: AVX2 in the baseline or
    dispatched and present on this CPU (a trailing '?' marks a dispatched
    feature the CPU lacks), and no AVX-512 baseline."""
    feats = cv2.getCPUFeaturesLine().split()
    baseline = [f for f in feats if not f.startswith("*")]
    runs = baseline + [f[1:] for f in feats if f.startswith("*") and not f.endswith("?")]
    return (cv2.useOptimized() and "AVX2" in runs
            and not any(f.startswith("AVX512") for f in baseline))


@pytest.mark.parametrize("width", [1, 17, 40, 131, 640])
def test_cvtcolor_equals_cv2(width):
    """Every colour conversion equal, on rows whose widths put pixels in
    OpenCV's vector loop and in its scalar tail. The copies follow OpenCV
    5.0's AVX2 vector loop (ops/imgproc's docstring), so a cv2 that runs
    another build of it is not the function they copy."""
    if not _cv2_color_hsv_runs_avx2():
        pytest.skip("cv2 does not run the AVX2 build of color_hsv "
                    f"(CPU features: {cv2.getCPUFeaturesLine()}), whose lane widths "
                    "ops/imgproc's colour copies follow")
    img = np.random.RandomState(width).randint(0, 256, (max(3, 60000 // width), width, 3),
                                               np.uint8)
    for fn, code in ((imgproc.bgr2hsv, cv2.COLOR_BGR2HSV), (imgproc.hsv2bgr, cv2.COLOR_HSV2BGR),
                     (imgproc.bgr2hls, cv2.COLOR_BGR2HLS), (imgproc.hls2bgr, cv2.COLOR_HLS2BGR)):
        assert np.array_equal(fn(img), cv2.cvtColor(img, code)), fn.__name__


def test_remap_cubic_blur_and_morphology_equal_cv2():
    rng = np.random.RandomState(2)
    src = rng.rand(40, 50).astype(np.float32) * 3000
    ys, xs = np.mgrid[:40, :50].astype(np.float32)
    mx = (xs + rng.randn(40, 50) * 8).astype(np.float32)
    my = (ys + rng.randn(40, 50) * 8).astype(np.float32)
    mx[0, :6] = np.arange(6) + 0.5  # ties round half to even
    my[0, :6] = np.arange(6) + 0.5
    want = cv2.remap(src, mx, my, interpolation=cv2.INTER_NEAREST,
                     borderMode=cv2.BORDER_REPLICATE)
    assert np.array_equal(imgproc.remap_nearest(src, mx, my), want)

    lattice = rng.rand(9, 9).astype(np.float32) * 2 - 1
    for h, w in ((48, 64), (37, 53)):
        want = cv2.resize(lattice, (w, h), interpolation=cv2.INTER_CUBIC)
        assert np.abs(imgproc.resize_cubic(lattice, (h, w)) - want).max() <= 2.5e-6

    img = rng.randint(0, 256, (37, 53, 3), np.uint8)
    for sigma in (0.3, 0.9, 1.8):
        assert np.array_equal(imgproc.gaussian_blur(img, 0, sigma),
                              cv2.GaussianBlur(img, (0, 0), sigma))
    f = rng.randint(0, 256, (37, 53, 3)).astype(np.float32)
    assert np.abs(imgproc.gaussian_blur(f, 3, 0.2) - cv2.GaussianBlur(f, (3, 3), 0.2)).max() <= 1e-5

    mask = (rng.rand(40, 60) > 0.6).astype(np.uint8)
    for k in (3, 10, 15):
        kernel = np.ones((k, k), np.uint8)
        assert np.array_equal(imgproc.dilate_rect(mask, k), cv2.dilate(mask, kernel))
        assert np.array_equal(imgproc.erode_rect(mask, k), cv2.erode(mask, kernel))
    assert np.array_equal(imgproc.erode_rect(imgproc.dilate_rect(mask, 15), 15),
                          cv2.morphologyEx(mask, cv2.MORPH_CLOSE, np.ones((15, 15), np.uint8)))
    padded = cv2.copyMakeBorder(mask, 1, 1, 1, 1, cv2.BORDER_CONSTANT, value=0)
    assert np.array_equal(imgproc.erode_rect(padded, 3, iterations=4),
                          cv2.erode(padded, np.ones((3, 3), np.uint8), iterations=4))


@pytest.mark.parametrize("angle", [-14.3, 2.5, 11.0])
def test_rotation_and_warp_affine_against_cv2(angle):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (45, 61, 3), np.uint8)
    m = cv2.getRotationMatrix2D((61 / 2, 45 / 2), angle, 1.0)
    assert np.array_equal(imgproc.rotation_matrix((61 / 2, 45 / 2), angle, 1.0), m)
    diff = np.abs(imgproc.warp_affine(img, m, (61, 45)).astype(int)
                  - cv2.warpAffine(img, m, (61, 45)).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    labels = rng.randint(0, 6, (45, 61)).astype(np.uint8)
    assert np.array_equal(imgproc.warp_affine(labels, m, (61, 45), nearest=True),
                          cv2.warpAffine(labels, m, (61, 45), flags=cv2.INTER_NEAREST))


# ---------------------------------------------------------------------------
# Perlin, augmentation, error maps
# ---------------------------------------------------------------------------

def test_perlin_distortion_against_the_reference():
    from quber_tpu.data.perlin import perlin_distortion as jax_perlin

    depth = np.random.RandomState(4).randint(400, 3000, (FRAME_H, FRAME_W)).astype(np.float32)
    depth[5:9, 10:20] = 0
    for seed in range(3):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got, want = TPerlin.perlin_distortion(depth, r1), jax_perlin(depth, r2)
        assert np.abs(got - want).max() <= 1e-3 and np.all(got[depth == 0] == 0)
        assert r1.rand() == r2.rand()  # the same draws consumed


def test_augmentations_against_the_reference():
    from quber_tpu.data import augmentation as JA
    from quber_tpu.data.mappers import ssd_color_aug as jax_ssd

    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (H, W, 3), np.uint8)
    for seed in range(8):
        for ours, theirs in ((TA.ssd_color_aug, jax_ssd), (TA.chromatic_shift, JA.chromatic_shift),
                             (TA.gaussian_blur, JA.gaussian_blur),
                             (TA.add_gaussian_noise, JA.add_gaussian_noise)):
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            assert np.array_equal(ours(img, r1), theirs(img, r2)), ours.__name__
            assert r1.rand() == r2.rand()
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        labels = rng.randint(0, 5, (H, W)).astype(np.uint8)
        got = TA.random_rotation([img, labels], r1, nearest=[False, True])
        want = JA.random_rotation([img, labels], r2, nearest=[False, True])
        diff = np.abs(got[0].astype(int) - want[0].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert np.array_equal(got[1], want[1])

    masks = np.zeros((3, H, W), np.uint8)
    masks[0, 5:20, 5:25] = masks[1, 25:40, 30:60] = masks[2, 10:30, 35:50] = 1
    depth = rng.rand(H, W, 3).astype(np.float32)
    for seed in range(5):
        args = (img, depth, masks, img[::-1].copy(), depth[::-1].copy(), masks[:, ::-1].copy())
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        got = TA.copy_paste(*args, r1, paired_masks=masks[:2], donor_paired=masks[1:, ::-1])
        want = JA.copy_paste(*args, r2, paired_masks=masks[:2], donor_paired=masks[1:, ::-1])
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_eee_maps_against_the_reference():
    from quber_tpu.data.eee import compute_eee_maps as jax_eee
    from quber_tpu.data.eee import mask_to_boundary as jax_boundary

    rng = np.random.RandomState(6)
    gt = (rng.rand(4, 50, 70) > 0.5).astype(np.uint8)
    gt[:, :10] = gt[:, -7:] = 1  # masks on the image border
    pred = np.roll(gt, 3, axis=2)[:3]
    got, want = TE.compute_eee_maps(gt, pred), jax_eee(gt, pred)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(TE.mask_to_boundary(gt[0]), jax_boundary(gt[0]))
    empty = np.zeros((0, 50, 70), np.uint8)
    for k, v in jax_eee(empty, pred).items():
        assert np.array_equal(TE.compute_eee_maps(empty, pred)[k], v)


# ---------------------------------------------------------------------------
# the mappers
# ---------------------------------------------------------------------------

def _same_sample(got, want, rgb_atol=0, depth_atol=0.0):
    assert got.keys() == want.keys()
    for k in TARGET_EXACT:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    for k, tol in TARGET_ATOL.items():
        assert got[k].shape == want[k].shape and np.abs(got[k] - want[k]).max() <= tol, k
    assert np.abs(got["image"][..., :3] - want["image"][..., :3]).max() <= rgb_atol
    assert np.abs(got["image"][..., 3:] - want["image"][..., 3:]).max() <= depth_atol


@pytest.mark.parametrize("aug", [False, True])
def test_perturbed_panoptic_mapper_against_the_reference(data_root, aug):
    from quber_tpu.data.mappers import PerturbedPanopticMapper as JMapper

    records, jrecords = _records(data_root)
    mc, tc, jmc, jtc = _configs(color_aug_ssd=aug, perlin_distortion=aug,
                                depth_range=(2500, 6000))
    ours, theirs = TM.PerturbedPanopticMapper(tc, mc, seed=4), JMapper(jtc, jmc, seed=4)
    for rec, jrec in zip(records, jrecords):
        _same_sample(ours(rec), theirs(jrec), rgb_atol=1 if aug else 0,
                     depth_atol=1e-3 if aug else 0.0)
    assert ours.rng.rand() == theirs.rng.rand()
    # the error maps derived on the host when the record stores none
    bare = [{k: v for k, v in r.items() if k not in TD.EEE_KEYS} for r in records[:2]]
    for rec in bare:
        _same_sample(ours(rec), theirs(rec), rgb_atol=1 if aug else 0,
                     depth_atol=1e-3 if aug else 0.0)


def test_copy_paste_and_multiscale_against_the_reference(data_root):
    from quber_tpu.data.mappers import PerturbedPanopticMapper as JMapper

    records, jrecords = _records(data_root)
    mc, tc, jmc, jtc = _configs(color_aug_ssd=False, perlin_distortion=False,
                                copy_paste_prob=0.7, min_size_train=(32, 40, 48),
                                max_size_train=64, size_divisibility=16)
    ours, theirs = TM.PerturbedPanopticMapper(tc, mc, seed=9), JMapper(jtc, jmc, seed=9)
    assert ours.multiscale and theirs.multiscale
    shapes = []
    for rec, jrec in zip(records * 2, jrecords * 2):
        got, want = ours(rec), theirs(jrec)
        _same_sample(got, want)
        shapes.append(got["image"].shape[:2])
        # zero loss weight in the padded margin
        rows = np.nonzero(got["image"].any(axis=(1, 2)))[0]
        assert got["center_weights"][rows.max() + 1:].sum() == 0
    assert len(set(shapes)) > 1  # more than one bucket drawn


def test_packed_mapper_file_branch_bytes(data_root):
    from quber_tpu.train.device_targets import PackedMapper as JPacked

    records, jrecords = _records(data_root)
    for aug in (False, True):
        mc, tc, jmc, jtc = _configs(color_aug_ssd=aug, perlin_distortion=aug,
                                    depth_range=(2500, 6000))
        ours, theirs = PackedMapper(tc, mc, n_slots=8), JPacked(jtc, jmc, n_slots=8)
        for rec, jrec in zip(records, jrecords):
            got, want = ours(rec)["packed"], theirs(jrec)["packed"]
            if not aug:
                assert np.array_equal(got, want)
            else:  # colour within a grey level; the depth byte within one
                assert got.shape == want.shape
                assert np.abs(got.astype(int) - want.astype(int))[:H * W * 4].max() <= 1
                assert np.array_equal(got[H * W * 4:], want[H * W * 4:])
        assert ours.rng.rand() == theirs.rng.rand()


def test_batch_iterator_and_worker_loader(data_root):
    from quber_tpu.data.mappers import PerturbedPanopticMapper as JMapper
    from quber_tpu.data.mappers import batch_iterator as jax_batches
    from quber_tpu_torch.data.pipeline import make_dataloader

    _records(data_root)
    mc, tc, jmc, jtc = _configs(color_aug_ssd=False, perlin_distortion=False)
    ours = TM.batch_iterator("uoais_sim_train_panoptic", TM.PerturbedPanopticMapper(tc, mc), 4,
                             seed=tc.seed)
    theirs = jax_batches("uoais_sim_train_panoptic", JMapper(jtc, jmc), 4, seed=jtc.seed)
    first = [next(ours) for _ in range(3)]
    for got in first:
        want = next(theirs)
        for k in TARGET_EXACT:
            assert np.array_equal(got[k], want[k]), k
        for k, tol in TARGET_ATOL.items():
            assert np.abs(got[k] - want[k]).max() <= tol, k

    with make_dataloader("uoais_sim_train_panoptic", TM.PerturbedPanopticMapper(tc, mc), 4,
                         seed=tc.seed, worker_count=2) as workers:
        for want in first:
            got = next(workers)
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), k
    layout = TM.to_step_layout(first[0], "cpu")
    assert layout["image"].shape == (4, 6, H, W) and layout["offset"].shape == (4, 2, H, W)
    assert layout["eee_mask"].shape == (4, 2, H, W) and layout["sem_seg"].shape == (4, H, W)


def test_make_dataloader_with_workers_zero_is_the_iterator(data_root):
    from quber_tpu_torch.data.pipeline import make_dataloader

    records, _ = _records(data_root)
    mc, tc, _, _ = _configs(color_aug_ssd=True, perlin_distortion=True)
    a = make_dataloader(records, TM.PerturbedPanopticMapper(tc, mc), 2, seed=3)
    b = TM.batch_iterator(records, TM.PerturbedPanopticMapper(tc, mc), 2, seed=3)
    for _ in range(2):
        x, y = next(a), next(b)
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_worker_loader_refuses_copy_paste(data_root):
    """Copy-paste's donor is the mapper's previous sample, which worker
    processes would make depend on their scheduling: the worker loader
    refuses it, and the in-process iterator keeps it."""
    from quber_tpu_torch.data.pipeline import make_dataloader

    records, _ = _records(data_root)
    mc, tc, _, _ = _configs(color_aug_ssd=False, perlin_distortion=False, copy_paste_prob=0.7)
    with pytest.raises(ValueError, match="item 11d"):
        make_dataloader(records, TM.PerturbedPanopticMapper(tc, mc), 2, worker_count=2)
    batch = next(make_dataloader(records, TM.PerturbedPanopticMapper(tc, mc), 2, worker_count=0))
    assert batch["image"].shape[0] == 2
