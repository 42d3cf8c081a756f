"""QuBER training entry point of the PyTorch/CUDA port.

    python3 train_net_torch.py --dataset uoais_sim_train_panoptic --data-root datasets \
        --config-file configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml \
        --output-dir output/flagship [--device-targets] [--workers N] [--resume] [--max-iter N]
    python3 train_net_torch.py --synthetic --device-targets ...
    torchrun --nproc-per-node N train_net_torch.py ...              (data parallel)
    torchrun --nnodes M --nproc-per-node N --rdzv-endpoint HOST:PORT \
        train_net_torch.py --multihost ...                          (across nodes)

Counterpart of train_net.py for quber_tpu_torch: Adam + WarmupPolyLR on a
registered dataset on disk under --data-root (data/datasets.py: the
UOAIS-Sim, TOD and ARMBench layouts; the images read, augmented and turned
into targets by data/mappers.PerturbedPanopticMapper, multi-scale when the
config's min_size_train has several sizes, one bucket shape a batch) or on
rendered synthetic scenes (--synthetic), checkpoints under
<output-dir>/ckpt. The config is a native YAML, a detectron2-format YAML or
an ablation-grid name. With --device-targets the host only reads, augments
and bitpacks (train/device_targets.PackedMapper) and the device rebuilds
every target inside the step; synthetic scenes then live on the device and
each batch is gathered there by a shuffled index (--no-data-device-cache
feeds them from the host instead). --workers N maps the records in N
worker processes (data/pipeline.py). With --eval-dataset, every
eval_period steps the current weights are evaluated on --eval-limit frames
of that dataset (perturbed GT refined without the foreground filter,
run_eval_torch's harness) and the row goes into <output-dir>/eval.csv
tagged train-eval@<it>. Each logged step's losses also go, unrounded, into
<output-dir>/metrics.jsonl. At the end a [timing] line gives seconds a
step, the host's wait for batches, the device's idle share between steps
and the world size.
Runs on the GPU unless --device cpu.

Data parallel (quber_tpu_torch/parallel): under torchrun each process is a
rank driving one device (cuda:LOCAL_RANK, or --device), in a process group
(NCCL on the card, gloo on the CPU), and the step is the
global batch's (synchronised BatchNorm, global loss normalisers, summed
gradients; train/loop.py). Without --multihost, batch_size is the global
batch, which must divide by the world size: every rank follows the
single-process order of samples and maps only its part of each batch (the
device pool gathers its slice of the same indices). With --multihost each
rank reads a stream of its own, seeded seed + rank, in local batches of
batch_size: the global batch is batch_size x world size. Rank 0 alone logs,
writes checkpoints (a barrier after each) and evaluates; on --resume every
rank restores the same checkpoint.

Not ported yet (exits with a message naming its item in ROADMAP.md):
--space > 1, height partitioning (item 12b).
"""

import argparse
import dataclasses
import json
import os
import time

# flag -> where ROADMAP.md queues the part of training it needs
_WAITING = {
    "space": "Queue 1 item 12b (height partitioning over a second mesh axis)",
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
    parser.add_argument("--weights-file", default=None,
                        help="start from these weights (an int8 .npz or a checkpoint "
                             "directory) instead of the seeded initialisation")
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
    parser.add_argument("--dataset", default="uoais_sim_train_panoptic")
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--workers", type=int, default=0,
                        help="worker processes of the data loader (0: in-process)")
    parser.add_argument("--space", type=int, default=1)
    parser.add_argument("--multihost", action="store_true",
                        help="under torchrun: each rank reads its own stream (seed + rank) "
                             "of local batches of batch_size")
    parser.add_argument("--eval-dataset", default=None,
                        help="evaluate every eval_period steps on this dataset (e.g. OSD)")
    parser.add_argument("--eval-dataset-path", default=None)
    parser.add_argument("--eval-limit", type=int, default=20)
    args = parser.parse_args(argv)

    for flag, item in _WAITING.items():
        if getattr(args, flag) != parser.get_default(flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: ROADMAP.md {item}")
    # torchrun sets RANK and WORLD_SIZE: a process group, of any size
    distributed = args.multihost or "WORLD_SIZE" in os.environ
    if distributed and "RANK" not in os.environ:
        raise SystemExit("--multihost and data parallelism run under torchrun (RANK, "
                         "WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment)")
    pool_cache = args.synthetic and args.device_targets and not args.no_data_device_cache
    if args.multihost and pool_cache:
        # the pool holds the global order of samples; --multihost's streams
        # are per rank (as train_net.py keeps the two apart)
        raise SystemExit("--multihost requires --no-data-device-cache")
    import numpy as np
    import torch

    from quber_tpu_torch.config import load_any_config
    from quber_tpu_torch.data.mappers import PerturbedPanopticMapper, to_step_layout
    from quber_tpu_torch.data.pipeline import make_dataloader
    from quber_tpu_torch.data.synthetic import synthetic_records
    from quber_tpu_torch.parallel import mesh as pmesh
    from quber_tpu_torch.train.checkpoint import restore_state, save_state
    from quber_tpu_torch.train.device_targets import (
        DevicePool, PackedMapper, make_device_target_step)
    from quber_tpu_torch.train.loop import create_train_state, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")
    mesh = None
    if distributed:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        # before any use of the card
        pmesh.initialize_multihost(device=device)
        mesh = pmesh.make_mesh(device)
    rank, world = (mesh.rank, mesh.world_size) if mesh is not None else (0, 1)
    log = print if rank == 0 else (lambda *a, **k: None)
    if device.type == "cuda":
        if mesh is not None:
            torch.cuda.set_device(device)  # the rank's card, for NCCL
        # float32 parity with the reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model_cfg, train_cfg = load_any_config(args.config_file)
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
    if world > 1 and not args.multihost:
        if train_cfg.batch_size % world:
            raise SystemExit(f"the global batch_size {train_cfg.batch_size} does not divide "
                             f"over {world} ranks")
        if not args.synthetic and not args.device_targets and len(train_cfg.min_size_train) > 1:
            raise SystemExit("multi-scale batches are grouped by shape after mapping, which a "
                             "rank mapping only its part of each batch cannot see: train "
                             "them data-parallel with --multihost")

    if args.synthetic:
        records = synthetic_records(args.synthetic_size, model_cfg.height, model_cfg.width,
                                    depth_range=train_cfg.depth_range,
                                    n_objects=args.n_objects, shapes=args.shapes)
    else:
        from quber_tpu_torch.data.datasets import get_dataset, register_standard_datasets

        register_standard_datasets(args.data_root)
        records = get_dataset(args.dataset)
        log(f"{len(records)} records of {args.dataset} under {args.data_root}")
    if args.device_targets:
        mapper = PackedMapper(train_cfg, model_cfg, n_slots=args.target_slots)
        train_step = make_device_target_step(model_cfg, train_cfg, n_slots=args.target_slots,
                                             mesh=mesh)
    elif args.synthetic:
        mapper = SyntheticMapper(train_cfg, model_cfg, n_slots=args.target_slots)
        train_step = make_train_step(model_cfg, mesh)
    else:
        mapper = PerturbedPanopticMapper(train_cfg, model_cfg, is_train=True)
        train_step = make_train_step(model_cfg, mesh)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"device: {device} ({name})" + (f", world size {world}" if mesh else ""), flush=True)
    state = create_train_state(model_cfg, train_cfg, device=device, mesh=mesh)
    if args.weights_file:
        from quber_tpu_torch.models.from_jax import as_state_dict
        from quber_tpu_torch.train.checkpoint import load_eval_params

        state.model.load_state_dict(as_state_dict(load_eval_params(args.weights_file)),
                                    strict=True)
        log(f"weights from {args.weights_file}")
    if args.resume and restore_state(ckpt_dir, state) is not None:
        if rank:
            # the checkpoint holds rank 0's dropout generator
            state.generator.manual_seed(pmesh.rank_seed(train_cfg.seed, mesh) + state.step)
        log(f"resumed at step {state.step}")
    if mesh is not None:
        pmesh.replicate(state.model, mesh)

    batches = None
    if pool_cache:
        packed = np.stack([mapper(r)["packed"] for r in records])
        next_batch = DevicePool(packed, train_cfg.batch_size, train_cfg.seed, device,
                                mesh=mesh if world > 1 else None).next_batch
    else:
        if args.multihost:  # a stream of its own a rank, local batches
            batches = make_dataloader(records, mapper, train_cfg.batch_size,
                                      seed=train_cfg.seed + rank, worker_count=args.workers)
        else:
            batches = make_dataloader(records, mapper, train_cfg.batch_size,
                                      seed=train_cfg.seed, worker_count=args.workers,
                                      shard=(rank, world) if world > 1 else None)

        def next_batch():
            batch = next(batches)
            if args.device_targets:
                return torch.from_numpy(batch["packed"]).to(device)
            if args.synthetic:
                return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            return to_step_layout(batch, device)

    t0 = time.time()
    timed = None  # steps since t0; None until the first step is done
    # after the first step: host seconds waiting for batches, wall seconds,
    # and the device's seconds from each step's first enqueue to its last
    # (CUDA events), whose shortfall against the wall is the device's idle
    # share between steps
    wait_s = excluded_s = 0.0
    events = []
    n_timed = 0
    t_start = None
    for it in range(state.step, train_cfg.max_iter):
        t_wait = time.perf_counter()
        batch = next_batch()
        t_ready = time.perf_counter()
        if device.type == "cuda" and timed is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        state, metrics = train_step(state, batch)
        if device.type == "cuda" and timed is not None:
            end.record()
            events.append((start, end))
        if timed is None:
            # the first step carries the kernels' build and cuDNN's set-up
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            local = (batch if torch.is_tensor(batch) else batch["image"]).shape[0]
            log(f"[timing] first_step_s={time.time() - t0:.1f} local_batch={local}", flush=True)
            t0, timed = time.time(), 0
            t_start = time.perf_counter()
        else:
            timed += 1
            n_timed += 1
            wait_s += t_ready - t_wait
        if (it + 1) % args.log_period == 0 or it + 1 == train_cfg.max_iter:
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            rate = f" ({timed / (time.time() - t0):.2f} it/s)" if timed else ""
            t0, timed = time.time(), 0
            log(f"iter {it + 1}/{train_cfg.max_iter} "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())) + rate,
                flush=True)
            if rank == 0:
                with open(os.path.join(output_dir, "metrics.jsonl"), "a") as f:
                    f.write(json.dumps({"iter": it + 1, **metrics}) + "\n")
        save = (it + 1) % train_cfg.checkpoint_period == 0 or it + 1 == train_cfg.max_iter
        evaluate = args.eval_dataset and (it + 1) % train_cfg.eval_period == 0
        if (save or evaluate) and device.type == "cuda":
            torch.cuda.synchronize(device)
        t_aside = time.perf_counter()  # checkpoints and evaluations are no step's time
        if save and rank == 0:
            save_state(ckpt_dir, state)
            print(f"checkpoint saved at {it + 1}", flush=True)
        if evaluate and rank == 0:
            from quber_tpu_torch.evaluation.harness import run_eval

            # a predictor of its own from a copy of the weights: the trainer's
            # module, its BatchNorm statistics and its dropout generator are
            # left as they are
            run_eval(base_model="perturbed-gt", refiner_model="maskrefiner-nofilter",
                     test_dataset=args.eval_dataset, dataset_path=args.eval_dataset_path,
                     config=model_cfg, params=state.model.state_dict(),
                     limit=args.eval_limit, csv_path=os.path.join(output_dir, "eval.csv"),
                     tag=f"train-eval@{it + 1}", device=device)
        if (save or evaluate) and mesh is not None:
            torch.distributed.barrier()  # the other ranks wait for rank 0's files
        excluded_s += time.perf_counter() - t_aside
    if batches is not None and hasattr(batches, "close"):
        batches.close()
    if n_timed:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t_start - excluded_s
        line = (f"[timing] steps={n_timed} s_per_step={wall_s / n_timed:.4f} "
                f"host_wait_s_per_step={wait_s / n_timed:.4f}")
        if events:
            busy_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
            line += f" device_s_per_step={busy_s / n_timed:.4f} idle_share={1 - busy_s / wall_s:.4f}"
        log(line + f" workers={args.workers} world_size={world}", flush=True)
    if mesh is not None:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
