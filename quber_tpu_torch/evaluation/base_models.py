"""Base (initial) segmenters for the evaluation harness.

Port of quber_tpu/evaluation/base_models.py: the oracle and test doubles
(GT, Empty, npy replay) and the perturbed GT used by the synthetic
protocols, behind the interface

    predict(rgb_path, depth_path) -> (masks [N, H, W] bool, fg_mask | None, seconds)

The learned base segmenters and where their weights come from:
  * `ucn`, `ucn-zoomin`: $QUBER_UCN_CKPT;
  * `msmformer`, `msmformer-zoomin`: $QUBER_MSMFORMER_NATIVE_CKPT;
  * `uoaisnet`, `uoaisnet-amodal`: $QUBER_UOAISNET_CKPT, with the score
    threshold $QUBER_UOAISNET_THRESH (default 0.5);
  * `uoisnet3d`: $QUBER_UOIS3D_DSN_CKPT and $QUBER_UOIS3D_RRN_CKPT (the
    ckpt_dsn / ckpt_rrn directories of train_zoo_torch.py --model uoisnet3d);
each a checkpoint directory of train_zoo_torch.py or an int8 .npz in the JAX
package's layout, and a random init when it is unset or holds no
checkpoint, as in the reference. The reference's released checkpoints:
  * `msmformer-pretrained`: $QUBER_MSMFORMER_CKPT (required);
  * `uoaisnet-pretrained`: $QUBER_UOAIS_CKPT (a random init without it, for
    timing), with $QUBER_CGNET_CKPT optionally naming the CGNet whose
    foreground filters its masks;
  * `uoisnet3d-pretrained`: $QUBER_UOIS_DSN_CKPT and $QUBER_UOIS_RRN_CKPT
    (each a random init without it);
each a reference .pth (read through models/import_zoo) or a save_params
directory of the port's state dict. `sam` and `sam-depth` are SAM's
automatic mask generator (models/sam_refiner) on the RGB or on the
normalised depth, at a seeded random init. The open-vocabulary base
segmenters (models/open_vocab):
  * `detic`: $QUBER_DETIC_CKPT (the ckpt directory of train_zoo_torch.py
    --model detic, its {text, detector} tree, with vocab.json beside the
    directory) and the confidence threshold $QUBER_DETIC_THRESH (default
    0.5);
  * `grounded-sam`: $QUBER_GSAM_CKPT (--model gsam's {text, grounder, sam}
    tree, with arch.json beside the directory, the SAM it trained) and the
    box threshold $QUBER_GSAM_THRESH (default 0.10);
each a seeded random init without its checkpoint.
"""

from __future__ import annotations

import os

import numpy as np

from quber_tpu_torch.data import png
from quber_tpu_torch.data.perturb import perturb_masks
from quber_tpu_torch.evaluation.datasets import BG_LABELS, EVAL_H, EVAL_W
from quber_tpu_torch.ops.preprocess import resize_nearest
from quber_tpu_torch.train.checkpoint import load_eval_params


class Empty:
    """No initial prediction."""

    def predict(self, rgb_path, depth_path):
        return np.zeros((0, EVAL_H, EVAL_W), bool), None, 0.0


class GT:
    """Oracle initial masks from the annotation."""

    def __init__(self, dataset: str = "OSD"):
        self.dataset = dataset

    def predict(self, rgb_path, depth_path):
        if self.dataset == "OSD":
            anno_path = rgb_path.replace("image_color", "annotation")
        elif self.dataset == "OCID":
            anno_path = rgb_path.replace("rgb", "label")
        elif self.dataset == "WISDOM":
            anno_path = rgb_path.replace("color_ims", "modal_segmasks")
        else:
            anno_path = rgb_path.replace("rgb", "annotation")
        anno = png.imread(anno_path)
        if anno.ndim == 3:
            # an RGB-encoded label image (or an annotation path that resolved
            # to the colour image): one channel, so the stack stays [N, H, W]
            anno = anno[..., 0]
        anno = resize_nearest(anno, (EVAL_H, EVAL_W))
        if self.dataset == "OCID":
            key = "floor" if "floor" in rgb_path else "table"
            for label in BG_LABELS[key]:
                anno[anno == label] = 0
        labels = np.unique(anno)
        labels = labels[labels != 0]
        masks = np.array([anno == l for l in labels]) if len(labels) else np.zeros((0, EVAL_H, EVAL_W), bool)
        return masks, None, 0.0


class LoadNpyBaseModel:
    """Replay pre-recorded initial masks (<npy_folder>/<frame>.npy)."""

    def __init__(self, npy_folder: str = ""):
        self.npy_folder = npy_folder

    def predict(self, rgb_path, depth_path):
        npy_path = os.path.join(
            self.npy_folder, os.path.basename(rgb_path).replace(".png", ".npy")
        )
        masks = np.load(npy_path)
        return np.asarray(masks) > 0, None, 0.0


class PerturbedGT:
    """GT masks perturbed with the data-generation corruptions, from one
    RandomState across the frames in order."""

    def __init__(self, dataset: str = "OSD", seed: int = 0,
                 target_iou=(0.6, 0.9), ratios: dict | None = None):
        self.gt = GT(dataset)
        self.rng = np.random.RandomState(seed)
        self.target_iou = target_iou
        self.ratios = ratios

    def predict(self, rgb_path, depth_path):
        masks, fg, t = self.gt.predict(rgb_path, depth_path)
        masks = perturb_masks(masks, self.rng, target_iou=self.target_iou,
                              ratios=self.ratios)
        return masks, fg, t


# graph-structure corruptions only (per-scene FP / split / merge, no
# boundary jitter)
STRUCTURAL_RATIOS = {"fp": 1.0, "over": 1.0, "under": 1.0, "delete": 0.0,
                     "boundary": 0.0}


def _restore_or_none(path: str):
    """The weights at `path` (train.checkpoint.load_eval_params), or None
    when the path is unset or holds no checkpoint."""
    if not path:
        return None
    from quber_tpu_torch.train.checkpoint import load_eval_params

    try:
        return load_eval_params(path)
    except FileNotFoundError:
        return None


def _reference_weights(path: str, importer):
    """The port's state dict from a reference .pth (through `importer`) or
    from a save_params directory holding the port's state dict. The JAX
    package's orbax directory of an imported checkpoint cannot be read: its
    flax layout flattens and transposes where the reference does not, so the
    reference .pth is what to pass."""
    import torch

    if path.endswith((".pth", ".pt")):
        from quber_tpu_torch.models.import_zoo import load_reference_checkpoint

        return importer(load_reference_checkpoint(path))
    from quber_tpu_torch.train.checkpoint import load_eval_params

    try:
        params = load_eval_params(path)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"{path} is an orbax checkpoint of the JAX package; pass the reference's .pth "
            "(read through quber_tpu_torch.models.import_zoo) instead") from e
    return {k: torch.as_tensor(v) for k, v in params.items()}


def _reference_weights_or_none(env: str, default: str, importer):
    """_reference_weights of $`env` (else `default`), or None (a random init,
    for timing without a checkpoint) where nothing is there."""
    try:
        return _reference_weights(os.environ.get(env, default), importer)
    except FileNotFoundError:
        return None


def _beside(ckpt: str, filename: str):
    """The JSON file `filename` beside the checkpoint directory `ckpt` (a
    recipe writes vocab.json / arch.json into its output directory)."""
    import json

    with open(os.path.join(os.path.dirname(os.path.abspath(ckpt)), filename)) as f:
        return json.load(f)


def build_base_model(name: str, dataset: str, npy_folder: str = "", device="cuda"):
    if name == "gt":
        return GT(dataset)
    if name == "empty":
        return Empty()
    if name == "npy":
        return LoadNpyBaseModel(npy_folder)
    if name == "perturbed-gt":
        return PerturbedGT(dataset)
    if name == "perturbed-gt-structural":
        return PerturbedGT(dataset, ratios=STRUCTURAL_RATIOS)
    if name in ("ucn", "ucn-zoomin"):
        from quber_tpu_torch.models.ucn import UCNBaseModel

        return UCNBaseModel(params=_restore_or_none(os.environ.get("QUBER_UCN_CKPT", "")),
                            dataset=dataset, zoom_in=name.endswith("zoomin"), device=device)
    if name in ("msmformer", "msmformer-zoomin"):
        from quber_tpu_torch.models.msmformer import MSMFormerBaseModel

        return MSMFormerBaseModel(
            params=_restore_or_none(os.environ.get("QUBER_MSMFORMER_NATIVE_CKPT", "")),
            dataset=dataset, zoom_in=name.endswith("zoomin"), device=device)
    if name in ("uoaisnet", "uoaisnet-amodal"):
        from quber_tpu_torch.models.uoais_net import UOAISNetBaseModel

        return UOAISNetBaseModel(
            params=_restore_or_none(os.environ.get("QUBER_UOAISNET_CKPT", "")),
            dataset=dataset, amodal=name.endswith("amodal"), device=device,
            score_threshold=float(os.environ.get("QUBER_UOAISNET_THRESH", "0.5")))
    if name == "msmformer-pretrained":
        from quber_tpu_torch.models.import_zoo import import_msmformer
        from quber_tpu_torch.models.msmformer_pretrained import PretrainedMSMFormerBaseModel

        ckpt = os.environ.get("QUBER_MSMFORMER_CKPT", "output/msmformer/ckpt")
        return PretrainedMSMFormerBaseModel(_reference_weights(ckpt, import_msmformer),
                                            dataset=dataset, device=device)
    if name == "uoaisnet-pretrained":
        from quber_tpu_torch.models.import_zoo import import_uoais_net
        from quber_tpu_torch.models.uoais_net_pretrained import UOAISNetPretrainedBaseModel

        params = _reference_weights_or_none("QUBER_UOAIS_CKPT", "output/uoais_net/ckpt",
                                            import_uoais_net)
        fg_ckpt = os.environ.get("QUBER_CGNET_CKPT", "")
        fg_params = _restore_or_none(fg_ckpt) if fg_ckpt else None
        return UOAISNetPretrainedBaseModel(params, dataset=dataset, fg_params=fg_params,
                                           device=device)
    if name == "uoisnet3d":
        from quber_tpu_torch.models.uois_net import UOISNet3DBaseModel

        return UOISNet3DBaseModel(
            dsn_params=_restore_or_none(os.environ.get("QUBER_UOIS3D_DSN_CKPT", "")),
            rrn_params=_restore_or_none(os.environ.get("QUBER_UOIS3D_RRN_CKPT", "")),
            dataset=dataset, device=device)
    if name == "uoisnet3d-pretrained":
        from quber_tpu_torch.models.import_zoo import import_uois_dsn, import_uois_rrn
        from quber_tpu_torch.models.uois_net_pretrained import UOISNet3DPretrainedBaseModel

        return UOISNet3DPretrainedBaseModel(
            _reference_weights_or_none("QUBER_UOIS_DSN_CKPT", "output/uois_dsn/ckpt",
                                       import_uois_dsn),
            _reference_weights_or_none("QUBER_UOIS_RRN_CKPT", "output/uois_rrn/ckpt",
                                       import_uois_rrn),
            dataset=dataset, device=device)
    if name in ("sam", "sam-depth"):
        from quber_tpu_torch.models.sam_refiner import SAMAutomaticBaseModel

        return SAMAutomaticBaseModel(dataset=dataset, depth_input=name == "sam-depth",
                                     device=device)
    if name == "detic":
        from quber_tpu_torch.models.open_vocab import DeticBaseModel

        ckpt = os.environ.get("QUBER_DETIC_CKPT", "")
        if not ckpt:
            return DeticBaseModel(dataset=dataset, device=device)
        return DeticBaseModel(
            params=load_eval_params(ckpt), dataset=dataset,
            vocabulary=_beside(ckpt, "vocab.json"), device=device,
            confidence_threshold=float(os.environ.get("QUBER_DETIC_THRESH", "0.5")))
    if name == "grounded-sam":
        from quber_tpu_torch.models.open_vocab import GroundedSAMBaseModel

        ckpt = os.environ.get("QUBER_GSAM_CKPT", "")
        if not ckpt:
            return GroundedSAMBaseModel(dataset=dataset, device=device)
        return GroundedSAMBaseModel(
            params=load_eval_params(ckpt), dataset=dataset, sam_arch=_beside(ckpt, "arch.json"),
            device=device, box_threshold=float(os.environ.get("QUBER_GSAM_THRESH", "0.10")))
    raise NotImplementedError(
        f"base model {name}; available: gt, empty, npy, perturbed-gt, "
        "perturbed-gt-structural, ucn, ucn-zoomin, msmformer, msmformer-zoomin, "
        "msmformer-pretrained, uoaisnet, uoaisnet-amodal, uoaisnet-pretrained, uoisnet3d, "
        "uoisnet3d-pretrained, sam, sam-depth, detic, grounded-sam")
