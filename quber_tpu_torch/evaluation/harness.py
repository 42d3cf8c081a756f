"""End-to-end evaluation harness: base segmenter -> refiner -> metrics.

Port of quber_tpu/evaluation/harness.py: walk a benchmark dataset, run the
initial segmenter and the refiner on each frame (one at a time, or streamed
in batches with `refine_batch`), turn masks into label images, compute the
Overlap / Boundary P/R/F (+ OSN, F@.75, mIoU) of both stages, print the
means, append a CSV row per stage and write the time_<dataset>[_<tag>].json
sidecar beside the CSV. The returned dict also holds `seconds`, the host
seconds the run spent in each stage (summed over frames; in the streamed
loop the stages overlap).
"""

from __future__ import annotations

import csv
import json
import os
import re
import time
from collections import OrderedDict

import numpy as np

from quber_tpu_torch.data import png
from quber_tpu_torch.evaluation.base_models import build_base_model
from quber_tpu_torch.evaluation.datasets import build_file_lists, load_annotation
from quber_tpu_torch.evaluation.metrics import multilabel_metrics
from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
from quber_tpu_torch.ops.preprocess import resize_linear

PRINT_KEYS = [
    "Objects F-measure",
    "Objects Precision",
    "Objects Recall",
    "Boundary F-measure",
    "Boundary Precision",
    "Boundary Recall",
    "Objects OSN F-measure",
    "Boundary OSN F-measure",
    "obj_detected_075_percentage",
    "obj_detected_075_percentage_normalized",
    "obj_mIOU",
]


def masks_to_label_image(masks, like: np.ndarray) -> np.ndarray:
    """Paste masks in order; later masks overwrite."""
    out = np.zeros_like(like, dtype=np.int32)
    for i, m in enumerate(masks):
        out[np.asarray(m) > 0] = i + 1
    return out


def aggregate(metrics_list: list[dict]) -> dict:
    """Mean of each numeric key over images (missing keys skipped)."""
    if not metrics_list:
        return {}
    result = {}
    for key in metrics_list[0]:
        vals = [m[key] for m in metrics_list if m.get(key) is not None]
        if vals:
            result[key] = float(np.mean(vals))
    return result


def print_table(tag: str, agg: dict):
    print(f"==== {tag} ====")
    for k in PRINT_KEYS:
        if k in agg:
            print(f"  {k:45s} {100 * agg[k]:6.2f}")


def save_csv(path: str, row: OrderedDict):
    """Append `row`, rewriting the file if its header differs: old rows get ""
    for the new fields, so files of mixed generations stay readable."""
    try:
        old_rows, old_fields = [], []
        if os.path.exists(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                old_fields = reader.fieldnames or []
                if old_fields != list(row.keys()):
                    old_rows = [dict(r) for r in reader]
        if old_fields and old_fields != list(row.keys()):
            merged = list(row.keys()) + [k for k in old_fields if k not in row]
            with open(path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=merged, restval="")
                writer.writeheader()
                for r in old_rows:
                    writer.writerow({k: r.get(k, "") for k in merged})
                writer.writerow(row)
            return
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not exists:
                writer.writeheader()
            writer.writerow(row)
    except OSError as e:  # never fail a finished evaluation on CSV IO
        print(f"CSV save failed: {e}")


def _save_timing(csv_path, test_dataset, tag, timing, avg_ms, std_ms):
    """time_<dataset>[_<tag>].json beside the CSV; a run that timed at most
    one frame does not replace an earlier measurement."""
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_", tag)[:80] if tag else ""
    path = os.path.join(
        os.path.dirname(os.path.abspath(csv_path)) or ".",
        f"time_{test_dataset}{'_' + slug if slug else ''}.json",
    )
    try:
        prev = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    prev = json.load(f)
            except (OSError, ValueError):
                prev = None
        if len(timing) <= 1 and prev and prev.get("average", 0) > 0:
            print(f"Keeping {path} (this run timed only {len(timing)} frame(s))")
        else:
            with open(path, "w") as f:
                json.dump({"average": avg_ms / 1000, "std": std_ms / 1000,
                           "n": len(timing)}, f)
    except OSError:
        pass


def run_eval(
    base_model="gt",
    refiner_model="maskrefiner",
    test_dataset="OSD",
    dataset_path=None,
    config=None,
    params=None,
    npy_folder="",
    limit=None,
    visualize=False,
    vis_dir="output/vis",
    csv_path="output/eval_results.csv",
    refine_batch=0,
    tag=None,
    device="cuda",
):
    base = base_model if not isinstance(base_model, str) else build_base_model(
        base_model, test_dataset, npy_folder, device=device
    )
    refiner = (
        refiner_model
        if not isinstance(refiner_model, str)
        else build_refiner_model(refiner_model, test_dataset, config, params, npy_folder,
                                 device=device)
    )
    rgb_paths, depth_paths, anno_paths = build_file_lists(test_dataset, dataset_path)
    if limit:
        rgb_paths, depth_paths, anno_paths = (
            rgb_paths[:limit], depth_paths[:limit], anno_paths[:limit],
        )

    initial_metrics_all, refined_metrics_all = [], []
    initial_times, refined_times = [], []
    seconds = {"annotation": 0.0, "base": 0.0, "metrics": 0.0}

    def score(anno, initial_masks, refined_masks):
        t0 = time.perf_counter()
        initial_pred = masks_to_label_image(initial_masks, anno)
        refined_pred = masks_to_label_image(refined_masks, anno)
        initial_metrics_all.append(multilabel_metrics(initial_pred, anno))
        refined_metrics_all.append(multilabel_metrics(refined_pred, anno))
        seconds["metrics"] += time.perf_counter() - t0
        return initial_pred, refined_pred

    def frame_inputs(rgb_path, depth_path, anno_path):
        t0 = time.perf_counter()
        anno = load_annotation(anno_path, test_dataset, rgb_path)
        t1 = time.perf_counter()
        initial_masks, fg_mask, t_init = base.predict(rgb_path, depth_path)
        seconds["annotation"] += t1 - t0
        seconds["base"] += time.perf_counter() - t1
        initial_times.append(t_init)
        return anno, initial_masks, fg_mask

    if refine_batch and hasattr(refiner, "predict_stream"):
        # the base predictions feed the refiner's batched pipeline lazily
        # (bounded look-ahead from the stream's producer thread)
        from collections import deque

        pending: deque = deque()

        def items():
            for rgb_path, depth_path, anno_path in zip(rgb_paths, depth_paths, anno_paths):
                anno, initial_masks, fg_mask = frame_inputs(rgb_path, depth_path, anno_path)
                pending.append((rgb_path, anno, initial_masks))
                yield (rgb_path, depth_path, initial_masks, fg_mask)

        t0 = time.perf_counter()
        n_done = 0
        for refined_masks, refined_output, _fg in refiner.predict_stream(
            items(), batch_size=refine_batch
        ):
            rgb_path, anno, initial_masks = pending.popleft()
            initial_pred, refined_pred = score(anno, initial_masks, refined_masks)
            if visualize:
                _save_visualization(vis_dir, test_dataset, rgb_path, anno, initial_pred,
                                    refined_pred, refined_output)
            n_done += 1
        total = time.perf_counter() - t0
        if n_done:
            print(
                f"Streamed refine: {n_done} frames in {total:.1f} s "
                f"-> {n_done / total:.1f} FPS (incl. base predict + metrics)"
            )
            refined_times = [total / n_done] * n_done
        seconds["stream"] = total
        rgb_paths = []  # the per-image loop below is skipped

    t_start = time.perf_counter()
    for rgb_path, depth_path, anno_path in zip(rgb_paths, depth_paths, anno_paths):
        anno, initial_masks, fg_mask = frame_inputs(rgb_path, depth_path, anno_path)

        if refiner is None:
            # "save" mode: dump the initial predictions as npy for a later
            # replay through the LoadNpy models
            save_dir = os.path.join("segfix", test_dataset, "initial_mask_predict")
            os.makedirs(save_dir, exist_ok=True)
            np.save(
                os.path.join(save_dir, os.path.basename(rgb_path).replace(".png", ".npy")),
                np.asarray(initial_masks, dtype=np.uint8) * 255,
            )
            continue

        refined_masks, refined_output, t_ref, fg_mask = refiner.predict(
            rgb_path, depth_path, initial_masks, fg_mask
        )
        refined_times.append(t_ref)
        if t_start is not None:
            # time to the first refined frame: model build, kernel build and
            # the first forward's set-up
            print(f"[timing] compile_s={time.perf_counter() - t_start:.1f}", flush=True)
            t_start = None

        initial_pred, refined_pred = score(anno, initial_masks, refined_masks)
        if visualize:
            _save_visualization(vis_dir, test_dataset, rgb_path, anno, initial_pred,
                                refined_pred, refined_output)

    # the first refine includes the warm-up: drop it from the timing
    timing = refined_times[1:] or refined_times
    avg_ms = 1000 * float(np.mean(timing)) if timing else 0.0
    std_ms = 1000 * float(np.std(timing)) if timing else 0.0
    print(f"Average refine time: {avg_ms:.2f} ms (std {std_ms:.2f})")
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    _save_timing(csv_path, test_dataset, tag, timing, avg_ms, std_ms)

    # provenance tag: checkpoint / protocol identity of the CSV row
    run_tag = tag or ("batch%d" % refine_batch if refine_batch else "per-image")

    results = {}
    for stage, metrics_all in [("initial", initial_metrics_all), ("refined", refined_metrics_all)]:
        agg = aggregate(metrics_all)
        print_table(f"{stage} ({test_dataset}, n={len(metrics_all)})", agg)
        results[stage] = agg
        row = OrderedDict(
            [("dataset", test_dataset), ("stage", stage),
             ("base", getattr(base, "__class__", type(base)).__name__),
             ("refiner", getattr(refiner, "__class__", type(refiner)).__name__),
             ("tag", run_tag),
             ("n_images", len(metrics_all)), ("avg_ms", avg_ms)]
            + [(k, agg.get(k)) for k in PRINT_KEYS]
        )
        save_csv(csv_path, row)
    results["avg_refine_ms"] = avg_ms
    results["std_refine_ms"] = std_ms
    seconds.update(getattr(refiner, "seconds", {}))
    results["seconds"] = seconds
    return results


def _save_visualization(vis_dir, dataset, rgb_path, anno, initial_pred, refined_pred,
                        refined_output):
    """Tiled colour / gt / initial / refined / panoptic overlays as one PNG."""
    os.makedirs(os.path.join(vis_dir, dataset), exist_ok=True)
    bgr = resize_linear(png.imread(rgb_path, bgr=True), anno.shape[:2])

    def colorize(label):
        rng = np.random.RandomState(1)
        colors = rng.randint(0, 255, (int(label.max()) + 1, 3), np.uint8)
        colors[0] = 0
        return colors[label]

    tiles = [bgr, colorize(anno), colorize(initial_pred), colorize(refined_pred)]
    if refined_output and "panoptic" in refined_output:
        tiles.append(colorize(np.asarray(refined_output["panoptic"])))
    canvas = np.concatenate(tiles, axis=1)
    # the tiles are in BGR order (cv2.imwrite's convention); PNG stores RGB
    png.imwrite(os.path.join(vis_dir, dataset, os.path.basename(rgb_path)),
                np.ascontiguousarray(canvas[..., ::-1]))
