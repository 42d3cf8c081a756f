"""Render a synthetic tabletop dataset to disk in a benchmark layout.

    python3 -m quber_tpu_torch.data.make_synthetic_dataset --out datasets/synth_osd \
        --n 200 --seed 1000 --depth-range 250 1500
    python3 -m quber_tpu_torch.data.make_synthetic_dataset --layout ocid \
        --out datasets/synth_ocid --n 36

The port's copy of tools/make_synthetic_dataset.py: the same flags and
defaults, the same renderer (data/synthetic.render_scene) drawing from one
RandomState in the same order, and the same stored arrays (colour uint8,
round(depth in mm) uint16, labels uint8, OCID's shifted labels, WISDOM's
float32 depth in metres), written with data/png.py (the PNG bytes may
differ from imageio's; the decoded arrays do not). Layouts, as the
evaluation walkers (evaluation/datasets.py) read them:

  osd     root/image_color/*.png, root/disparity/*.png (16-bit mm),
          root/annotation/*.png (labels from 1)
  ocid    root/{ARID20,YCB10,ARID10}/<floor|table>/<bottom|top>[/<cat>]/
          <seq>/{rgb,depth,label}/*.png; labels follow OCID's convention
          (floor scenes: floor=1, objects from 2; table scenes: floor=1,
          table=2, objects from 3), which the annotation loader zeroes
  wisdom  root/color_ims/image_%06d.png, root/depth_ims_numpy/
          image_%06d.npy (float32 metres), root/modal_segmasks/
          image_%06d.png, root/test_indices.npy selecting the test frames
  hope / dopose   root/{rgb,depth,annotation}/*.png
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np

from quber_tpu_torch.data import png
from quber_tpu_torch.data.synthetic import render_scene

# OCID's directory vocabulary per sub-dataset
OCID_TREE = {
    "ARID20": [["floor", "table"], ["bottom", "top"]],
    "YCB10": [["floor", "table"], ["bottom", "top"],
              ["cuboid", "curved", "mixed"]],
    "ARID10": [["floor", "table"], ["bottom", "top"],
               ["box", "curved", "fruits", "mixed", "non-fruits"]],
}


def _render(rng, args):
    n_objects = (rng.randint(args.n_objects[0], args.n_objects[1] + 1)
                 if args.n_objects else None)
    rgb, depth_mm, masks = render_scene(
        rng, args.height, args.width, depth_range=tuple(args.depth_range),
        dropout_frac=args.dropout_frac, n_objects=n_objects,
        shapes=args.shapes,
    )
    label = np.zeros(rgb.shape[:2], np.uint8)
    for k, m in enumerate(masks, start=1):
        label[m > 0] = k
    return rgb, depth_mm, label


def write_osd(args, rng, subdirs=("image_color", "disparity", "annotation")):
    for sub in subdirs:
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    for i in range(args.n):
        rgb, depth_mm, label = _render(rng, args)
        name = f"synth_{i:05d}.png"
        png.imwrite(os.path.join(args.out, subdirs[0], name), rgb)
        png.imwrite(os.path.join(args.out, subdirs[1], name),
                    np.round(depth_mm).astype(np.uint16))
        png.imwrite(os.path.join(args.out, subdirs[2], name), label)
    return args.n


def _ocid_labels(label, depth_mm, floor_or_table):
    """OCID's background labels on a rendered label image: floor scenes carry
    floor=1 with objects from 2; table scenes floor=1, table=2 with objects
    from 3, and a far strip of floor seen past the table."""
    shift = 1 if floor_or_table == "floor" else 2
    out = np.where(label > 0, label + shift, 0).astype(np.uint8)
    support = (label == 0) & (depth_mm > 0)
    if floor_or_table == "floor":
        out[support] = 1
    else:
        out[support] = 2
        out[:8, :][label[:8, :] == 0] = 1
    return out


def write_ocid(args, rng):
    leaves = []
    for sub, levels in OCID_TREE.items():
        for combo in itertools.product(*levels):
            leaves.append(os.path.join(args.out, sub, *combo, "seq01"))
    for i in range(args.n):
        leaf = leaves[i % len(leaves)]
        f_or_t = "floor" if f"{os.sep}floor{os.sep}" in leaf else "table"
        for sub in ("rgb", "depth", "label"):
            os.makedirs(os.path.join(leaf, sub), exist_ok=True)
        rgb, depth_mm, label = _render(rng, args)
        label = _ocid_labels(label, depth_mm, f_or_t)
        name = f"result_{i:04d}.png"
        png.imwrite(os.path.join(leaf, "rgb", name), rgb)
        png.imwrite(os.path.join(leaf, "depth", name), np.round(depth_mm).astype(np.uint16))
        png.imwrite(os.path.join(leaf, "label", name), label)
    return args.n


def write_wisdom(args, rng):
    for sub in ("color_ims", "depth_ims_numpy", "modal_segmasks"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    # n test frames among extra frames, selected by a shuffled subset in
    # test_indices.npy, as the real dataset indexes its test split
    total = args.n + max(2, args.n // 4)
    idx = rng.permutation(total)[:args.n]
    for i in range(total):
        rgb, depth_mm, label = _render(rng, args)
        name = f"image_{i:06d}"
        png.imwrite(os.path.join(args.out, "color_ims", name + ".png"), rgb)
        np.save(os.path.join(args.out, "depth_ims_numpy", name + ".npy"),
                (depth_mm / 1000.0).astype(np.float32))
        png.imwrite(os.path.join(args.out, "modal_segmasks", name + ".png"), label)
    np.save(os.path.join(args.out, "test_indices.npy"), np.sort(idx).astype(np.int64))
    return args.n


WRITERS = {
    "osd": write_osd,
    "ocid": write_ocid,
    "wisdom": write_wisdom,
    "hope": lambda a, r: write_osd(a, r, ("rgb", "depth", "annotation")),
    "dopose": lambda a, r: write_osd(a, r, ("rgb", "depth", "annotation")),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--layout", default="osd", choices=sorted(WRITERS))
    parser.add_argument("--n", type=int, default=200)
    parser.add_argument("--seed", type=int, default=1000)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--depth-range", type=float, nargs=2, default=(250.0, 1500.0))
    parser.add_argument("--dropout-frac", type=float, default=0.002,
                        help="fraction of zero-depth sensor-dropout pixels "
                             "(exercises the inpainting)")
    parser.add_argument("--n-objects", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="objects per scene sampled uniformly in [LO, HI] "
                             "(default: the renderer's 3-8)")
    parser.add_argument("--shapes", default="mixed", choices=["convex", "mixed", "concave"],
                        help="silhouette vocabulary: convex superellipses only, the "
                             "mixed default, or all-concave scenes")
    args = parser.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    n = WRITERS[args.layout](args, rng)
    print(f"wrote {n} scenes to {args.out} ({args.layout} layout)")


if __name__ == "__main__":
    main()
