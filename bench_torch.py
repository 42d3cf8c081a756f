"""Serving benchmark of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_torch.py

Counterpart of bench.py for quber_tpu_torch. It serves 96 distinct rendered
480x640 scenes (data/synthetic.render_scene from RandomState(7), 3-8
objects, depth normalised to 250-1500 mm) in batches of 16 through
MaskRefinerPredictor on the card, with the weights of $QUBER_BENCH_CKPT
(any flavour train.checkpoint.load_eval_params reads), else the in-repo
int8 archive, else a random init (`weights` says which).

Configurations, each staged on the card first (stage_frames, untimed) and
served through predict_batch_stream_staged after one warm pass; a pass's
time ends when its last frame is on the host:
  * headline (`value`): bfloat16, 24 centre candidates, 24 instance slots,
    median of 5 passes;
  * `fps_default_config`: bfloat16 at 200 candidates and 64 slots, median
    of 3; `fps_k200_n24` and `fps_k24_n64`, the two single-axis hybrids,
    best of 2, and the gaps they attribute (`gap_topk_ms`, `gap_slots_ms`);
  * `fps_float32`: the headline config in float32, the port's default
    precision, median of 3;
  * `streaming_fps`: the headline config through predict_batch_stream (the
    frames packed on the host, uploaded and served in one pipeline), median
    of 5, with its trials; beside it the host's pack time (`pack_ms`), the
    upload fenced by a synchronise (`h2d_ms_fenced`), the staged time per
    frame (`compute_drain_ms`), the bound they give and the efficiency of
    the best streamed trial against it.
`flops_forward` is torch.utils.flop_counter's count of one B = 1 forward;
`mfu_forward` divides flops_forward x value by the H100 SXM dense bf16 peak
(`peak_tflops`, NVIDIA's data sheet, at the 700 W limit; the card's own
limit is `power_limit_w`). Runs on CUDA only; without a card it exits with
code 2.

Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
BATCH = 16
PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense, NVIDIA data sheet
BASELINE_FPS = 30.0  # the reference's north star: > 30 FPS per chip end to end


def render_frames(n: int):
    """n distinct scenes: (BGR uint8, depth channel uint8, masks bool)."""
    from quber_tpu_torch.data.synthetic import render_scene
    from quber_tpu_torch.ops.preprocess import normalize_depth

    rng = np.random.RandomState(7)
    frames = []
    for _ in range(n):
        rgb, depth_mm, masks = render_scene(rng, H, W, (250.0, 1500.0))
        frames.append((rgb, normalize_depth(depth_mm)[..., 0], [m > 0 for m in masks]))
    return frames


def load_weights():
    """(params, name): $QUBER_BENCH_CKPT, else the int8 archive, else None."""
    from quber_tpu_torch.train.checkpoint import load_default_params, load_eval_params

    path = os.environ.get("QUBER_BENCH_CKPT")
    if path:
        return load_eval_params(path), "trained"
    params = load_default_params()
    return params, ("trained-int8" if params is not None else "random")


def _passes(predictor, staged, n_frames: int, trials: int) -> list[float]:
    """Frames per second of `trials` staged passes after a warm one."""
    for pan, count, _ in predictor.predict_batch_stream_staged(staged):
        if pan.shape != (H, W) or not 0 <= count <= predictor.config.top_k_instances:
            raise AssertionError(f"bad output: {pan.shape}, {count} instances")
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        n = sum(1 for _ in predictor.predict_batch_stream_staged(staged))
        rates.append(n / (time.perf_counter() - t0))
        if n != n_frames:
            raise AssertionError(f"{n} results for {n_frames} frames")
    return rates


def staged_rates(frames, params, trials: int, dtype="bfloat16", top_k=24, slots=24):
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    cfg = MaskRefinerConfig(dtype=dtype, top_k_instances=top_k)
    predictor = MaskRefinerPredictor(cfg, params, max_instances=slots, device="cuda")
    staged = predictor.stage_frames(frames, BATCH)
    return _passes(predictor, staged, len(frames), trials), predictor


def forward_flops(predictor) -> int:
    """FLOPs of one B = 1 forward of the predictor's model at its configured
    size, as counted by torch.utils.flop_counter (convolutions and matrix
    products)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cfg = predictor.config
    images = torch.zeros((1, 6, cfg.height, cfg.width), device=predictor.device)
    enc = torch.zeros((1, 3, cfg.height, cfg.width), device=predictor.device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        predictor.model(images, enc)
    return int(counter.get_total_flops())


def host_stages(predictor, frames):
    """(pack ms, fenced H2D ms) per frame: the host's assembly of pinned
    batches, then each batch's upload followed by a synchronise."""
    import torch

    batches = [frames[i:i + BATCH] for i in range(0, len(frames), BATCH)]
    t0 = time.perf_counter()
    assembled = [predictor._assemble(b, BATCH)[0] for b in batches]
    pack_ms = 1e3 * (time.perf_counter() - t0) / len(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tensors in assembled:
        uploaded = predictor._upload(tensors)
        torch.cuda.synchronize()
        del uploaded
    return pack_ms, 1e3 * (time.perf_counter() - t0) / len(frames)


def card_info():
    """(name, power limit in W) as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return name, float(limit)


def summarise(fps, fps_default, fps_k200_n24, fps_k24_n64, fps_float32, streaming,
              pack_ms, h2d_ms, flops, **extra) -> dict:
    """The JSON line from the measured rates and host stages."""
    compute_drain_ms = 1e3 / fps
    stages = {"pack": pack_ms, "h2d": h2d_ms, "compute_drain": compute_drain_ms}
    bottleneck = max(stages, key=stages.get)
    bound_fps = 1e3 / stages[bottleneck]
    return {
        "metric": "e2e_refine_fps_per_chip_480x640",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        **extra,
        "fps_default_config": round(fps_default, 2),
        "default_gap_pct": round(100.0 * (1.0 - fps_default / fps), 1),
        "fps_k200_n24": round(fps_k200_n24, 2),
        "fps_k24_n64": round(fps_k24_n64, 2),
        "gap_topk_ms": round(1e3 / fps_k200_n24 - 1e3 / fps, 3),
        "gap_slots_ms": round(1e3 / fps_k24_n64 - 1e3 / fps, 3),
        "fps_float32": round(fps_float32, 2),
        "flops_forward": flops,
        "mfu_forward": round(flops * fps / (PEAK_BF16_TFLOPS * 1e12), 4),
        "peak_tflops": PEAK_BF16_TFLOPS,
        "streaming_fps": round(statistics.median(streaming), 2),
        "streaming_fps_best": round(max(streaming), 2),
        "streaming_trials": [round(r, 2) for r in sorted(streaming)],
        "pack_ms": round(pack_ms, 3),
        "h2d_ms_fenced": round(h2d_ms, 3),
        "compute_drain_ms": round(compute_drain_ms, 3),
        "pipeline_bound_fps": round(bound_fps, 2),
        "pipeline_efficiency": round(max(streaming) / bound_fps, 3),
        "bottleneck": bottleneck,
    }


def run(n_frames: int = 96, trials: int | None = None, frames=None) -> dict:
    """Measure everything above on the card and return the JSON line's
    dict. The command line runs the defaults; chip_smoke.py's shortened run
    passes `trials`, which replaces every configuration's number of passes,
    and `frames`, n_frames frames it read beforehand (then render_s is
    null)."""
    import torch

    def n(default):
        return trials or default

    device, power = card_info()
    params, weights = load_weights()
    render_s = None
    if frames is None:
        t0 = time.perf_counter()
        frames = render_frames(n_frames)
        render_s = round(time.perf_counter() - t0, 1)
    if len(frames) != n_frames:
        raise ValueError(f"{len(frames)} frames for n_frames={n_frames}")

    rates, predictor = staged_rates(frames, params, n(5))
    fps = statistics.median(rates)
    flops = forward_flops(predictor)
    pack_ms, h2d_ms = host_stages(predictor, frames)
    streaming = []
    for _ in range(n(5)):
        t0 = time.perf_counter()
        count = sum(1 for _ in predictor.predict_batch_stream(iter(frames), BATCH))
        streaming.append(count / (time.perf_counter() - t0))
    del predictor
    torch.cuda.empty_cache()
    rates_d, _ = staged_rates(frames, params, n(3), top_k=200, slots=64)
    fps_k200_n24 = max(staged_rates(frames, params, n(2), top_k=200, slots=24)[0])
    fps_k24_n64 = max(staged_rates(frames, params, n(2), top_k=24, slots=64)[0])
    rates_f32, _ = staged_rates(frames, params, n(3), dtype="float32")
    return summarise(
        fps, statistics.median(rates_d), fps_k200_n24, fps_k24_n64,
        statistics.median(rates_f32), streaming, pack_ms, h2d_ms, flops,
        weights=weights, device=device, power_limit_w=power, frames=n_frames,
        batch_size=BATCH, trials=[round(r, 2) for r in rates], render_s=render_s)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
