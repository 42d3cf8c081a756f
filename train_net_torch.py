"""QuBER training entry point of the PyTorch/CUDA port (one GPU).

    python3 train_net_torch.py --synthetic --device-targets \
        --config-file configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml \
        --output-dir output/flagship [--resume] [--max-iter N]

Counterpart of train_net.py for quber_tpu_torch: Adam + WarmupPolyLR on
rendered synthetic scenes, checkpoints under <output-dir>/ckpt. With
--device-targets the host only bitpacks the masks and the device rebuilds
every target inside the step; the packed scenes then live on the device and
each batch is gathered there by a shuffled index (--no-data-device-cache
feeds them from the host instead). With --eval-dataset, every eval_period
steps the current weights are evaluated on --eval-limit frames of that
dataset (perturbed GT refined without the foreground filter, run_eval_torch's
harness) and the row goes into <output-dir>/eval.csv tagged train-eval@<it>.
Runs on the GPU unless --device cpu.

Not ported yet (each exits with a message naming its item in ROADMAP.md):
training on datasets on disk (--dataset), --workers, --space and
--multihost.
"""

import argparse
import dataclasses
import os
import time

# flag -> where ROADMAP.md queues the part of training it needs
_WAITING = {
    "dataset": "Queue 1 item 11b (file-backed mappers and augmentation)",
    "workers": "Queue 1 item 11b (worker processes for the file-backed loader)",
    "space": "Queue 1 item 12 (data parallel and spatial partitioning)",
    "multihost": "Queue 1 item 12 (data parallel)",
}


class SyntheticMapper:
    """Host mapper of in-memory records to the step's batch fields (channels
    first): the targets are built by the same functions as on the device
    path, on the CPU, one sample at a time."""

    def __init__(self, train_cfg, model_cfg, n_slots: int):
        from quber_tpu_torch.train.device_targets import PackedMapper

        self._pack = PackedMapper(train_cfg, model_cfg, n_slots)
        self.tc, self.mc, self.n_slots = train_cfg, model_cfg, n_slots

    def __call__(self, record):
        import torch

        from quber_tpu_torch.train.device_targets import build_targets, unpack_train_sample

        buf = torch.from_numpy(self._pack(record)["packed"])[None]
        image, gt, gv, pert, pv = unpack_train_sample(buf, self.mc.height, self.mc.width,
                                                      self.n_slots)
        sample = build_targets(gt, gv, pert, pv, self.mc, self.tc)
        sample["image"] = image
        return {k: v[0].numpy() for k, v in sample.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file",
                        default="configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max-iter", type=int, default=None)
    parser.add_argument("--checkpoint-period", type=int, default=None)
    parser.add_argument("--log-period", type=int, default=20)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on rendered scenes (needs no dataset on disk)")
    parser.add_argument("--synthetic-size", type=int, default=32)
    parser.add_argument("--n-objects", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="--synthetic: objects per scene sampled in [LO, HI] "
                             "(default: the renderer's 3-8)")
    parser.add_argument("--shapes", default="mixed", choices=["convex", "mixed", "concave"],
                        help="--synthetic: silhouette vocabulary")
    parser.add_argument("--depth-range", type=float, nargs=2, default=None,
                        help="override the depth normalisation range (mm)")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--device-targets", action="store_true",
                        help="build all training targets on the device inside the step "
                             "(the host only bitpacks the masks)")
    parser.add_argument("--target-slots", type=int, default=32,
                        help="instance-slot bound of the packed samples")
    parser.add_argument("--no-data-device-cache", action="store_true",
                        help="feed --synthetic --device-targets batches from the host "
                             "instead of a device-resident pool")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--space", type=int, default=1)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--eval-dataset", default=None,
                        help="evaluate every eval_period steps on this dataset (e.g. OSD)")
    parser.add_argument("--eval-dataset-path", default=None)
    parser.add_argument("--eval-limit", type=int, default=20)
    args = parser.parse_args(argv)

    for flag, item in _WAITING.items():
        if getattr(args, flag) != parser.get_default(flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: ROADMAP.md {item}")
    if not args.synthetic:
        raise SystemExit("only --synthetic training is ported: ROADMAP.md " + _WAITING["dataset"])

    import numpy as np
    import torch

    from quber_tpu_torch.config import load_config
    from quber_tpu_torch.data.mappers import batch_iterator
    from quber_tpu_torch.data.synthetic import synthetic_records
    from quber_tpu_torch.train.checkpoint import restore_state, save_state
    from quber_tpu_torch.train.device_targets import (
        DevicePool, PackedMapper, make_device_target_step)
    from quber_tpu_torch.train.loop import create_train_state, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")
        # float32 parity with the reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model_cfg, train_cfg = load_config(args.config_file)
    if args.height or args.width:
        model_cfg = dataclasses.replace(model_cfg, height=args.height or model_cfg.height,
                                        width=args.width or model_cfg.width)
    if args.max_iter:
        train_cfg = dataclasses.replace(train_cfg, max_iter=args.max_iter)
    if args.checkpoint_period:
        train_cfg = dataclasses.replace(train_cfg, checkpoint_period=args.checkpoint_period)

    if args.depth_range:
        train_cfg = dataclasses.replace(train_cfg, depth_range=tuple(args.depth_range))
    output_dir = args.output_dir or os.path.join(
        "output", os.path.splitext(os.path.basename(args.config_file))[0])
    ckpt_dir = os.path.join(output_dir, "ckpt")
    os.makedirs(output_dir, exist_ok=True)

    records = synthetic_records(args.synthetic_size, model_cfg.height, model_cfg.width,
                                depth_range=train_cfg.depth_range, n_objects=args.n_objects,
                                shapes=args.shapes)
    if args.device_targets:
        mapper = PackedMapper(train_cfg, model_cfg, n_slots=args.target_slots)
        train_step = make_device_target_step(model_cfg, train_cfg, n_slots=args.target_slots)
    else:
        mapper = SyntheticMapper(train_cfg, model_cfg, n_slots=args.target_slots)
        train_step = make_train_step(model_cfg)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    state = create_train_state(model_cfg, train_cfg, device=device)
    if args.resume and restore_state(ckpt_dir, state) is not None:
        print(f"resumed at step {state.step}")

    if args.device_targets and not args.no_data_device_cache:
        packed = np.stack([mapper(r)["packed"] for r in records])
        next_batch = DevicePool(packed, train_cfg.batch_size, train_cfg.seed, device).next_batch
    else:
        batches = batch_iterator(records, mapper, train_cfg.batch_size, seed=train_cfg.seed)

        def next_batch():
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(batches).items()}
            return batch["packed"] if args.device_targets else batch

    t0 = time.time()
    timed = None  # steps since t0; None until the first step is done
    for it in range(state.step, train_cfg.max_iter):
        state, metrics = train_step(state, next_batch())
        if timed is None:
            # the first step carries the kernels' build and cuDNN's set-up
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"[timing] first_step_s={time.time() - t0:.1f}", flush=True)
            t0, timed = time.time(), 0
        else:
            timed += 1
        if (it + 1) % args.log_period == 0 or it + 1 == train_cfg.max_iter:
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            rate = f" ({timed / (time.time() - t0):.2f} it/s)" if timed else ""
            t0, timed = time.time(), 0
            print(f"iter {it + 1}/{train_cfg.max_iter} "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())) + rate,
                  flush=True)
        if (it + 1) % train_cfg.checkpoint_period == 0 or it + 1 == train_cfg.max_iter:
            save_state(ckpt_dir, state)
            print(f"checkpoint saved at {it + 1}")
        if args.eval_dataset and (it + 1) % train_cfg.eval_period == 0:
            from quber_tpu_torch.evaluation.harness import run_eval

            # a predictor of its own from a copy of the weights: the trainer's
            # module, its BatchNorm statistics and its dropout generator are
            # left as they are
            run_eval(base_model="perturbed-gt", refiner_model="maskrefiner-nofilter",
                     test_dataset=args.eval_dataset, dataset_path=args.eval_dataset_path,
                     config=model_cfg, params=state.model.state_dict(),
                     limit=args.eval_limit, csv_path=os.path.join(output_dir, "eval.csv"),
                     tag=f"train-eval@{it + 1}", device=device)


if __name__ == "__main__":
    main()
