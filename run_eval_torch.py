"""Evaluation entry point of the PyTorch/CUDA port (one GPU).

    python3 run_eval_torch.py --base-model perturbed-gt --refiner-model maskrefiner \
        --test-dataset OSD --dataset-path datasets/synth_osd \
        --weights-file weights/flagship_synth_int8.npz --csv output/eval_torch.csv

Counterpart of run_eval.py for quber_tpu_torch, with its flags: without
--use-cgnet, "maskrefiner" runs unfiltered ("maskrefiner-nofilter"), and the
CSV tag defaults to <weights basename>|<per-image or batchN>[|limitN]. The
harness also writes time_<dataset>[_<tag>].json beside the CSV, so --csv
points into a directory of its own (by default output/, ignored by git). Runs on the GPU
(--gpu N picks cuda:N) and exits with an error when there is none;
--device cpu is for tests. Needs no OpenCV, imageio or Pillow.
"""

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file",
                        default="configs/mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")
    parser.add_argument("--base-model", default="gt",
                        help="gt | empty | npy | perturbed-gt | perturbed-gt-structural | ucn | "
                             "ucn-zoomin | msmformer | msmformer-zoomin | msmformer-pretrained | "
                             "uoaisnet | uoaisnet-amodal | uoaisnet-pretrained | uoisnet3d | "
                             "uoisnet3d-pretrained (weights: $QUBER_UCN_CKPT, "
                             "$QUBER_MSMFORMER_NATIVE_CKPT, $QUBER_MSMFORMER_CKPT, "
                             "$QUBER_UOAISNET_CKPT, $QUBER_UOAIS_CKPT, $QUBER_UOIS3D_DSN_CKPT "
                             "and _RRN_CKPT, $QUBER_UOIS_DSN_CKPT and _RRN_CKPT)")
    parser.add_argument("--refiner-model", default="maskrefiner",
                        help="maskrefiner | maskrefiner-nofilter | identity | npy | save | "
                             "cascadepsp | cascadepsp-rgbd | rice (weights: --weights-file, "
                             "else $QUBER_CASCADEPSP_CKPT / $QUBER_RICE_CKPT; "
                             "$QUBER_RICE_SEARCH greedy or cem)")
    parser.add_argument("--test-dataset", default="OSD",
                        help="OSD | OCID | WISDOM | HOPE | DoPose")
    parser.add_argument("--dataset-path", default=None)
    parser.add_argument("--use-cgnet", action="store_true",
                        help="filter refined instances with the foreground segmenter "
                             "(without it 'maskrefiner' runs unfiltered)")
    parser.add_argument("--gpu", type=int, default=0, help="index of the CUDA device")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu is for tests")
    parser.add_argument("--weights-file", default=None,
                        help="int8 .npz weights or a checkpoint directory of "
                             "train_net_torch.py (random init if omitted)")
    parser.add_argument("--npy-folder", default="")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--refine-batch", type=int, default=0,
                        help="stream refinement in batches of this size (0 = per-image)")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--vis_dir", default="output/vis")
    parser.add_argument("--csv", default="output/eval_results.csv")
    parser.add_argument("--tag", default=None,
                        help="provenance tag recorded in the CSV row "
                             "(default: <weights-basename>|<mode>[|limitN])")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("run_eval_torch: no CUDA device (pass --device cpu to run on the CPU)",
                  file=sys.stderr)
            return 2
        device = f"cuda:{args.gpu}"
        torch.cuda.set_device(device)
    else:
        device = "cpu"

    from quber_tpu_torch.config import load_any_config
    from quber_tpu_torch.evaluation.harness import run_eval
    from quber_tpu_torch.train.checkpoint import load_eval_params

    model_cfg, _ = load_any_config(args.config_file)

    params = load_eval_params(args.weights_file) if args.weights_file else None

    refiner_name = args.refiner_model
    if refiner_name == "maskrefiner" and not args.use_cgnet:
        refiner_name = "maskrefiner-nofilter"

    tag = args.tag
    if tag is None:
        ckpt = "random-init"
        if args.weights_file:
            ckpt = os.path.basename(os.path.normpath(args.weights_file))
        mode = f"batch{args.refine_batch}" if args.refine_batch else "per-image"
        tag = f"{ckpt}|{mode}" + (f"|limit{args.limit}" if args.limit else "")

    results = run_eval(
        base_model=args.base_model,
        refiner_model=refiner_name,
        test_dataset=args.test_dataset,
        dataset_path=args.dataset_path,
        config=model_cfg,
        params=params,
        npy_folder=args.npy_folder,
        limit=args.limit,
        visualize=args.visualize,
        vis_dir=args.vis_dir,
        csv_path=args.csv,
        refine_batch=args.refine_batch,
        tag=tag,
        device=device,
    )
    seconds = ", ".join(f"{k} {v:.3f}" for k, v in results["seconds"].items())
    print(f"host seconds by stage (summed over frames): {seconds}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
