"""One-command reference-parity drill: a MaskRefiner .pth -> one verdict.

    python3 -m quber_tpu_torch.tools.parity_drill --torch model_final.pth \\
        [--dataset OSD --dataset-path datasets/OSD] [--limit 25] \\
        [--out parity_drill.json]

Port of tools/parity_drill.py. One command runs the whole seam and writes one
JSON report:

  1. import: the detectron2 MaskRefiner state dict -> the port's MaskRefiner
     (models/import_torch.py);
  2. activation parity: the port's activations stage by stage against a
     plain torch re-execution of the reference layers from the same state
     dict (tools/activation_parity.py) at --parity-size;
  3. harness evaluation: the imported weights through run_eval
     (evaluation/harness.py) with the unfiltered refiner on the given
     dataset, or, without --dataset-path, on --synthetic-n scenes rendered in
     the OSD layout by data/make_synthetic_dataset.py (seed 1000, depth
     250-1500 mm, no dropout) under --workdir, with the perturbed-gt base;
  4. the report: import coverage, every parity stage and the worst, the
     evaluation's initial and refined metrics and its refine time.

Runs on --device (cuda unless cpu is given; no card: an error) in float32
with TF32 off. The exit status is non-zero unless the import succeeds and
every parity stage matches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from quber_tpu_torch.config import load_any_config
from quber_tpu_torch.tools import FLAGSHIP_CONFIG, resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--torch", required=True,
                        help=".pth MaskRefiner state dict (reference layout)")
    parser.add_argument("--config", default=FLAGSHIP_CONFIG)
    parser.add_argument("--dataset", default="OSD", help="harness dataset of the eval leg")
    parser.add_argument("--dataset-path", default=None,
                        help="a dataset root; without it, rendered synthetic OSD-layout scenes")
    parser.add_argument("--base-model", default="perturbed-gt",
                        help="harness base model of the eval leg")
    parser.add_argument("--synthetic-n", type=int, default=20)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--parity-size", type=int, nargs=2, default=(128, 128),
                        metavar=("H", "W"), help="the activation-parity input size")
    parser.add_argument("--atol", type=float, default=3e-4)
    parser.add_argument("--eval-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                        help="the eval leg's model and scene size (default: the config's); "
                             "the weights do not depend on it")
    parser.add_argument("--workdir", default="output/parity_drill")
    parser.add_argument("--out", default="parity_drill.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.harness import run_eval
    from quber_tpu_torch.models.import_torch import import_mask_refiner, load_torch_checkpoint
    from quber_tpu_torch.tools.activation_parity import parity

    device = resolve_device(args.device)
    report = {"torch": os.path.abspath(args.torch), "config": args.config,
              "device": str(device)}

    # 1. import
    cfg = load_any_config(args.config)[0]
    sd = load_torch_checkpoint(args.torch)
    params = import_mask_refiner(sd, cfg)
    n_params = sum(v.numel() for v in params.values())
    report["import"] = {"n_torch_tensors": len(sd), "n_params": n_params}
    print(f"[1/3] import ok: {len(sd)} torch tensors -> {n_params:,} params")

    # 2. activation parity
    ph, pw = args.parity_size
    rng = np.random.RandomState(0)
    images = (rng.rand(1, ph, pw, 6) * 255).astype(np.float32)
    offset = rng.rand(1, ph, pw, 3).astype(np.float32)
    stages = parity(sd, dataclasses.replace(cfg, height=ph, width=pw), images, offset,
                    args.atol, device)
    n_bad = sum(1 for v in stages.values() if v.get("status") != "ok")
    worst = max(stages, key=lambda k: stages[k].get("max_abs", float("inf")))
    report["parity"] = {"n_stages": len(stages), "n_mismatched": n_bad,
                        "worst_stage": worst,
                        "worst_max_abs": stages[worst].get("max_abs", float("nan")),
                        "atol": args.atol, "stages": stages}
    print(f"[2/3] parity: {len(stages) - n_bad}/{len(stages)} stages match (worst {worst}, "
          f"max|d| {report['parity']['worst_max_abs']:.2e})")

    # 3. harness evaluation
    if args.eval_size:
        cfg = dataclasses.replace(cfg, height=args.eval_size[0], width=args.eval_size[1])
    dataset_path = args.dataset_path
    if dataset_path is None:
        dataset_path = os.path.join(args.workdir, "synth_osd")
        marker = os.path.join(dataset_path, "image_color")
        if not os.path.isdir(marker) or len(os.listdir(marker)) < args.synthetic_n:
            print(f"    rendering {args.synthetic_n} synthetic scenes -> {dataset_path}")
            make_dataset(["--out", dataset_path, "--n", str(args.synthetic_n), "--height",
                          str(cfg.height), "--width", str(cfg.width), "--dropout-frac", "0"])
    os.makedirs(args.workdir, exist_ok=True)
    results = run_eval(base_model=args.base_model, refiner_model="maskrefiner-nofilter",
                       test_dataset=args.dataset, dataset_path=dataset_path, config=cfg,
                       params=params, limit=args.limit,
                       csv_path=os.path.join(args.workdir, "eval_results.csv"), device=device)
    report["eval"] = {"dataset": args.dataset, "dataset_path": os.path.abspath(dataset_path),
                      "base_model": args.base_model, "initial": results["initial"],
                      "refined": results["refined"], "avg_refine_ms": results["avg_refine_ms"]}
    print("[3/3] harness eval done")

    report["ok"] = n_bad == 0
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(("PARITY DRILL OK" if report["ok"] else
           f"PARITY DRILL FAILED ({n_bad} mismatched stages)") + f" -> {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
