"""Where predict() and a train step spend their time on the card.

    python -m quber_tpu_torch.profiling [--out build/profile]

Serves 8 seeded synthetic 480x640 frames through the port's predictor with
the in-repo int8 flagship weights, then reports:
  * per-stage device time with CUDA events around the predictor's stages
    (encode, forward, centre NMS, group + merge), the host time it takes to
    enqueue the encode stage, and the host-side rest of predict() (uploads,
    readback, instance extraction);
  * a torch.profiler trace of a few frames: the device-busy share of the
    wall time and the top kernels by device time (key_averages), written
    with the Chrome trace under --out;
  * the same for staged batched serving of 24 frames in batches of 8:
    per-stage device time of a batch (encode, forward, heads + centre NMS,
    group + merge with its host sync), the forward's rate, and the
    device-busy share of a profiled staged pass;
  * a breakdown of the flagship train step at batch 8 from a device pool of
    16 rendered scenes (targets, forward with the losses, backward,
    optimizer: CUDA events at the step's phase marks), the host time of a
    step and the peak device memory, without and with `remat_backbone`.
Needs CUDA, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

FRAMES = 8
BATCH = 8
BATCH_FRAMES = 24
TRAIN_POOL = 16
TRAIN_SLOTS = 32
TRAIN_STEPS = 8
TRAIN_PHASES = ("targets", "forward", "backward", "optimizer")


class PhaseTimer:
    """CUDA events at the phase marks of one train step: pass `mark` to the
    step between `start()` and `phases()`."""

    def __init__(self):
        self._events = []

    def start(self):
        self._events = []
        self.mark("start")

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events.append((name, ev))

    def phases(self) -> dict:
        """Device ms of each phase since the mark before it (synchronises)."""
        torch.cuda.synchronize()
        return {name: self._events[i][1].elapsed_time(ev)
                for i, (name, ev) in enumerate(self._events[1:])}


def packed_scene_pool(model_cfg, train_cfg, n_scenes: int, n_slots: int, seed: int):
    """uint8 [n_scenes, sample_bytes]: seeded rendered scenes, packed for the
    device-target step (host work, numpy)."""
    from quber_tpu_torch.data.synthetic import synthetic_records
    from quber_tpu_torch.train.device_targets import PackedMapper

    records = synthetic_records(n_scenes, model_cfg.height, model_cfg.width, seed=seed,
                                depth_range=train_cfg.depth_range)
    mapper = PackedMapper(train_cfg, model_cfg, n_slots)
    return np.stack([mapper(r)["packed"] for r in records])


def timed_train_steps(state, train_step, next_batch, steps: int) -> list[dict]:
    """Run `steps` train steps; for each, the host ms (ending in a
    synchronise), the device ms of its phases and the losses as floats."""
    timer = PhaseTimer()
    rows = []
    for _ in range(steps):
        bufs = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timer.start()
        _, metrics = train_step(state, bufs, timer.mark)
        phases = timer.phases()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3, "phases": phases,
                     "losses": {k: float(v) for k, v in metrics.items()}})
    return rows


def _targets_breakdown(bufs, model_cfg, train_cfg) -> dict:
    """Device ms of the parts of the step's target phase for one packed
    batch (the stages of train.device_targets.build_targets, spelled out)."""
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.ops.encoding import panoptic_train_targets
    from quber_tpu_torch.ops.morphology import quadruple_error_maps
    from quber_tpu_torch.train.device_targets import unpack_train_sample

    timer = PhaseTimer()
    sigma = train_cfg.gaussian_sigma
    with torch.no_grad():
        timer.start()
        _, gt, gv, pert, pv = unpack_train_sample(bufs, model_cfg.height, model_cfg.width,
                                                  TRAIN_SLOTS)
        timer.mark("unpack")
        stats = kernels.instance_stats(gt, gv)
        panoptic_train_targets(gt, gv, sigma=sigma, stats=stats)
        timer.mark("statistics_and_panoptic_targets")
        _, centers, ok = kernels.instance_stats(pert, pv, return_ok=True)
        kernels.encode_initial_masks_batched(pert, ok, centers, sigma, normalize=True)
        timer.mark("statistics_and_input_encoding")
        quadruple_error_maps(gt, pert, gv, pv)
        timer.mark("error_maps")
    return timer.phases()


def _train_report(params):
    """The flagship train step at batch 8 from the given weights, and the
    same with `remat_backbone` (the trunk blocks' activations recomputed in
    the backward pass) for its cost in time and its gain in memory."""
    import dataclasses

    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step
    from quber_tpu_torch.train.loop import create_train_state

    model_cfg, train_cfg = MaskRefinerConfig(), TrainConfig(batch_size=BATCH, warmup_iters=2)
    packed = packed_scene_pool(model_cfg, train_cfg, TRAIN_POOL, TRAIN_SLOTS, seed=11)
    weights = state_dict_from_jax(params)

    def run(cfg, steps):
        state = create_train_state(cfg, train_cfg, device="cuda")
        state.model.load_state_dict(weights, strict=True)
        pool = DevicePool(packed, BATCH, train_cfg.seed, "cuda")
        train_step = make_device_target_step(cfg, train_cfg, TRAIN_SLOTS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows = timed_train_steps(state, train_step, pool.next_batch, steps)
        steady = rows[2:]
        return pool, {
            "steps": steps,
            "step_ms_median": statistics.median(r["ms"] for r in steady),
            "frames_per_s": BATCH * 1e3 / statistics.median(r["ms"] for r in steady),
            "phases_median_ms": {p: statistics.median(r["phases"][p] for r in steady)
                                 for p in TRAIN_PHASES},
            "first_step_ms": rows[0]["ms"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "total_loss": [r["losses"]["total_loss"] for r in rows],
        }

    pool, report = run(model_cfg, TRAIN_STEPS)
    bufs = pool.next_batch()
    targets = [_targets_breakdown(bufs, model_cfg, train_cfg) for _ in range(5)]
    del pool, bufs
    _, remat = run(dataclasses.replace(model_cfg, remat_backbone=True), 5)
    return {
        "batch": BATCH, "slots": TRAIN_SLOTS, "pool": TRAIN_POOL, **report,
        "targets_phase_median_ms": {k: statistics.median(t[k] for t in targets)
                                    for k in targets[0]},
        "remat_backbone": remat,
    }


def _device_busy(fn):
    """(wall ms, device ms, key_averages) of fn() under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side rows only (kernels, copies, memsets): operator rows carry
    # their kernels' time too and would count it twice
    device_rows = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device_rows) / 1e3
    return wall_ms, device_ms, prof, device_rows


def _batch_stage_times(pred, tensors):
    """Device ms of each stage of one staged batch (CUDA events); the
    stages of MaskRefinerPredictor._dispatch, spelled out."""
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import _images

    img4, masks, valid = tensors
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        t0 = time.perf_counter()
        _, centers, ok = kernels.instance_stats(masks, valid, return_ok=True)
        enc = kernels.encode_initial_masks_batched(masks, ok, centers)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        out = pred.model(_images(img4), enc)
        ev[2].record()
        pre = pred._heads(out)
        ev[3].record()
        pred._group_and_post_batch(pre)
        ev[4].record()
    torch.cuda.synchronize()
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(
        ("encode", "forward", "heads_and_centre_nms", "group_and_merge"))}
    stages["encode_enqueue_host"] = enqueue_ms
    return stages


def _batched_report(pred, h, w, forward_flop, out_dir):
    """Stage times, forward rate and device-busy share of staged serving."""
    from quber_tpu_torch.data.synthetic import blob_scene

    frames = []
    for i in range(BATCH_FRAMES):
        rng = np.random.RandomState(200 + i)
        frames.append(blob_scene(rng, h, w, rng.randint(3, 9)))
    staged = pred.stage_frames(frames, BATCH)
    list(pred.predict_batch_stream_staged(staged))  # warm-up: cuDNN at B = 8
    torch.cuda.synchronize()
    per_batch = [_batch_stage_times(pred, t) for t, _ in staged]
    med = {k: statistics.median(p[k] for p in per_batch) for k in per_batch[0]}
    wall_ms, device_ms, prof, device_rows = _device_busy(
        lambda: list(pred.predict_batch_stream_staged(staged)))
    prof.export_chrome_trace(os.path.join(out_dir, "staged_trace.json"))
    top = sorted(device_rows, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    return {
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top],
        "batch": BATCH, "frames": BATCH_FRAMES,
        "stages_median_ms_per_batch": med,
        "forward_tflop_per_s": BATCH * forward_flop / med["forward"] / 1e9,
        "profiled_staged_wall_ms": wall_ms, "profiled_staged_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
    }


def _stage_times(pred, frame):
    """Device ms of each stage of predict_raw for one frame (CUDA events),
    and host ms of a whole predict() call on it."""
    from quber_tpu_torch.ops.grouping import find_instance_centers

    rgb, depth, masks = frame
    dev, cfg = pred.device, pred.config
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.inference_mode():
        image = torch.from_numpy(pred._assemble_image(rgb, depth)).to(dev)
        m = torch.from_numpy(np.asarray(masks, bool)).to(dev)
        valid = torch.ones((m.shape[0],), dtype=torch.bool, device=dev)
        ev[0].record()
        t0 = time.perf_counter()
        enc = pred._encode(m, valid)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        out = pred.model(image.permute(2, 0, 1)[None], enc[None])
        ev[2].record()
        find_instance_centers(out["center"][0, 0], cfg.center_threshold,
                              cfg.nms_kernel, cfg.top_k_instances)
        ev[3].record()
        pre = pred._pre(image, m, valid)  # the same stages again, untimed
        ev[4].record()
        pred._group_and_post(pre)
        ev[5].record()
    torch.cuda.synchronize()
    stages = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in
              ((0, "encode"), (1, "forward"), (2, "centre_nms"), (4, "group_and_merge"))}
    # host time to enqueue the encode stage: with an idle device ahead of it,
    # the stage's device time cannot be shorter
    stages["encode_enqueue_host"] = enqueue_ms
    t0 = time.perf_counter()
    pred.predict(rgb, depth, list(masks))
    torch.cuda.synchronize()
    stages["predict_wall"] = (time.perf_counter() - t0) * 1e3
    return stages


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()

    from quber_tpu_torch.data.synthetic import blob_scene
    from quber_tpu_torch.predictor import MaskRefinerPredictor
    from quber_tpu_torch.train.checkpoint import load_default_params

    params = load_default_params()
    pred = MaskRefinerPredictor(params=params, device="cuda")
    h, w = pred.config.height, pred.config.width
    frames = []
    for i in range(FRAMES):
        rng = np.random.RandomState(100 + i)
        frames.append(blob_scene(rng, h, w, rng.randint(3, 9)))
    for f in frames[:2]:  # warm-up: cuDNN heuristics, kernel build
        pred.predict(*f)
    torch.cuda.synchronize()

    per_frame = [_stage_times(pred, f) for f in frames]
    med = {k: statistics.median(p[k] for p in per_frame) for k in per_frame[0]}
    device_sum = sum(med[k] for k in ("encode", "forward", "centre_nms", "group_and_merge"))
    med["host_rest"] = med["predict_wall"] - device_sum

    # operations of one forward (convolutions and matrix products), for the
    # achieved rate against the card's float32 peak outside the tensor cores
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        pred.model(torch.zeros((1, 6, h, w), device="cuda"),
                   torch.zeros((1, 3, h, w), device="cuda"))
    forward_flop = fc.get_total_flops()

    os.makedirs(args.out, exist_ok=True)

    def four_frames():
        for f in frames[:4]:
            pred.predict(*f)

    wall_ms, device_ms, prof, device_rows = _device_busy(four_frames)
    prof.export_chrome_trace(os.path.join(args.out, "predict_trace.json"))
    top = sorted(device_rows, key=lambda e: e.self_device_time_total, reverse=True)[:25]
    table = [{"name": e.key[:80], "calls": e.count,
              "device_ms": e.self_device_time_total / 1e3} for e in top]
    with open(os.path.join(args.out, "key_averages.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    batched = _batched_report(pred, h, w, forward_flop, args.out)
    del pred
    torch.cuda.empty_cache()
    train = _train_report(params)
    print(json.dumps({
        "card": smi,
        "stages_median_ms": med,
        "forward_flop": forward_flop,
        "forward_tflop_per_s": forward_flop / med["forward"] / 1e9,
        "profiled_frames": 4, "profiled_wall_ms": wall_ms,
        "profiled_device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "top_kernels": table,
        "batched_staged": batched,
        "train_step": train,
    }, indent=1))


if __name__ == "__main__":
    main()
