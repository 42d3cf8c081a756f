"""The reference-checkpoint seam, as command-line tools run with `python3 -m`:

  * `import_checkpoint`: a reference .pth -> a checkpoint directory of the
    port (and a MaskRefiner back to the detectron2 layout with --export);
  * `quantize_checkpoint`: a checkpoint directory -> the int8 release
    archive;
  * `activation_parity`: the MaskRefiner stage by stage against a plain
    torch re-execution of the reference forward from the same state dict;
  * `parity_drill`: import -> activation parity -> harness evaluation, one
    JSON report.

Each runs on the card unless `--device cpu` is passed, and exits with an
error where no card is found.
"""

from __future__ import annotations

import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_CONFIG = os.path.join(ROOT, "configs",
                               "mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")


def resolve_device(name: str) -> torch.device:
    """The device `name`; on the card with TF32 off (the float32 forward
    the parity checks hold to). No card: SystemExit, no fallback."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to run on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
