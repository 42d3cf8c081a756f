"""Seeded synthetic tabletop scenes (numpy).

`blob_scene` makes the frames of the serving smoke runs and parity tests: a
shaded, noisy table plane with elliptical objects of distinct colour that
stand nearer the camera, and initial masks that are the objects' visible
masks perturbed by a shift of a few pixels (what a base segmenter hands the
refiner).

`render_scene` and `synthetic_records` are the training data source, a copy
of quber_tpu/data/synthetic.py with the same draws from the same seed:
occlusion-aware composite superellipse objects over a tilted, textured table
plane that lies farther than the objects; smooth object surfaces; per-object
albedo, textures whose colour edges do not coincide with boundaries, and
pixel noise; GT masks are the VISIBLE regions.
"""

from __future__ import annotations

import numpy as np


def blob_scene(rng: np.random.RandomState, h: int, w: int, n_objects: int):
    """-> (rgb uint8 [h, w, 3] BGR, depth uint8 [h, w, 3] normalised to 0..255
    and replicated, initial masks bool [n, h, w]); n <= n_objects, since an
    object hidden behind later ones is dropped."""
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    table = rng.randint(40, 110, 3).astype(np.float32)
    rgb = table + rng.randn(h, w, 3).astype(np.float32) * 4.0
    rgb *= (0.85 + 0.3 * xs / w)[..., None]
    depth = 180.0 + 30.0 * (ys / h - 0.5) + rng.randn(h, w).astype(np.float32)

    label = np.zeros((h, w), np.int32)
    r_lo, r_hi = max(6, min(h, w) // 14), max(10, min(h, w) // 6)
    for k in range(1, n_objects + 1):
        a, b = rng.uniform(r_lo, r_hi, 2)
        cy = rng.uniform(a, h - a)
        cx = rng.uniform(b, w - b)
        theta = rng.uniform(0, np.pi)
        u = (ys - cy) * np.cos(theta) + (xs - cx) * np.sin(theta)
        v = -(ys - cy) * np.sin(theta) + (xs - cx) * np.cos(theta)
        m = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        colour = rng.randint(60, 255, 3).astype(np.float32)
        rgb = np.where(m[..., None], colour + rng.randn(h, w, 3) * 4.0, rgb)
        depth = np.where(m, rng.uniform(60.0, 140.0) + 0.1 * u, depth)
        label[m] = k

    masks = []
    for k in range(1, n_objects + 1):
        vis = label == k
        if vis.sum() < 64:
            continue
        dy, dx = rng.randint(-4, 5, 2)
        masks.append(np.roll(vis, (int(dy), int(dx)), axis=(0, 1)))
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    depth = np.repeat(np.clip(depth, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
    masks = np.asarray(masks, bool).reshape(-1, h, w)
    return rgb, depth, masks


def _superellipse(ys, xs, cy, cx, a, b, theta, p):
    """Boolean mask of a rotated superellipse."""
    dy, dx = ys - cy, xs - cx
    u = np.cos(theta) * dx + np.sin(theta) * dy
    v = -np.sin(theta) * dx + np.cos(theta) * dy
    return (np.abs(u / a) ** p + np.abs(v / b) ** p) <= 1.0


def _radial(ys, xs, cy, cx, a, b, theta, p):
    """1 at the part center falling to 0 at its boundary (shading/bumps)."""
    dy, dx = ys - cy, xs - cx
    u = np.cos(theta) * dx + np.sin(theta) * dy
    v = -np.sin(theta) * dx + np.cos(theta) * dy
    return np.maximum(
        1.0 - (np.abs(u / a) ** p + np.abs(v / np.maximum(b, 1)) ** p), 0.0
    )


def _sample_part(rng, cy, cx, r_lo, r_hi, thin_ok=True):
    """Random superellipse parameters around (cy, cx)."""
    a = rng.randint(r_lo, r_hi)
    if thin_ok and rng.rand() < 0.18:
        # thin structure: bar/handle silhouette, 3+ px half-width so the
        # visible mask survives perturbation and the area cull
        a = int(a * rng.uniform(1.2, 1.8))
        b = max(3, int(a * rng.uniform(0.08, 0.2)))
    else:
        b = int(a * rng.uniform(0.5, 1.0))
    theta = rng.uniform(0, np.pi)
    p = rng.choice([2.0, 2.0, 3.0, 5.0])
    return cy, cx, a, max(b, 1), theta, p


def _boundary_point(rng, part):
    """A random point on (roughly) the part's boundary, for attaching lobes
    and bites."""
    cy, cx, a, b, theta, _p = part
    phi = rng.uniform(0, 2 * np.pi)
    u, v = a * np.cos(phi), b * np.sin(phi)
    py = cy + np.sin(theta) * u + np.cos(theta) * v
    px = cx + np.cos(theta) * u - np.sin(theta) * v
    return py, px


def _texture(rng, h, w, ys, xs, base_rgb, kind=None):
    """Procedural surface texture: albedo field [h, w, 3] around base_rgb."""
    if kind is None:
        kind = rng.choice(["plain", "plain", "stripes", "checker", "blotch"])
    out = np.broadcast_to(base_rgb, (h, w, 3)).astype(np.float32).copy()
    if kind == "plain":
        return out, kind
    second = np.clip(
        base_rgb + rng.uniform(-1, 1, 3) * rng.uniform(30, 90), 0, 255
    ).astype(np.float32)
    th = rng.uniform(0, np.pi)
    u = np.cos(th) * xs + np.sin(th) * ys
    v = -np.sin(th) * xs + np.cos(th) * ys
    period = rng.uniform(8, 40)
    if kind == "stripes":
        mix = (np.sin(2 * np.pi * u / period) > 0)[..., None]
    elif kind == "checker":
        mix = (((u // period).astype(int) + (v // period).astype(int)) % 2 == 0)[..., None]
    else:  # blotch: thresholded sum of low-frequency sinusoids
        f = np.zeros((h, w), np.float32)
        for _ in range(3):
            ky, kx = rng.uniform(1, 4, 2)
            f += np.sin(2 * np.pi * (ky * ys / h + kx * xs / w) + rng.rand() * 6)
        mix = (f > 0)[..., None]
    return np.where(mix, second, out), kind


def _render_object(rng, ys, xs, h, w, lo, span, r_lo, r_hi, shapes):
    """One composite object: (mask bool, depth float32 [+inf outside], rgb).

    The object is a union of 1-3 superellipse parts minus bites/holes.
    Depth is the nearest part surface per pixel; holes expose the
    background (they are genuinely open, as in a mug handle from above).
    """
    margin = max(10, min(h, w) // 10)
    cy = rng.randint(margin, h - margin)
    cx = rng.randint(margin, w - margin)
    base = _sample_part(rng, cy, cx, r_lo, r_hi, thin_ok=shapes != "convex")
    parts = [base]

    concave = shapes == "concave" or (shapes == "mixed" and rng.rand() < 0.55)
    cuts = []
    if shapes != "convex" and concave:
        features = 1 + (rng.rand() < 0.3)
        for _ in range(features):
            roll = rng.rand()
            if roll < 0.45:  # extra lobe -> L/T/blob union
                py, px = _boundary_point(rng, base)
                parts.append(
                    _sample_part(rng, py, px, max(3, r_lo // 2),
                                 max(4, int(r_hi * 0.7)))
                )
            elif roll < 0.75:  # bite: notch cut at the boundary
                py, px = _boundary_point(rng, base)
                cuts.append(
                    _sample_part(rng, py, px, max(3, r_lo // 2),
                                 max(4, int(r_hi * 0.6)), thin_ok=False)
                )
            else:  # interior hole (ring/mug): exposes the table through it
                _cy, _cx, a, b, th, _p = base
                off = rng.uniform(0, 0.3)
                phi = rng.uniform(0, 2 * np.pi)
                hy = _cy + off * b * np.sin(phi)
                hx = _cx + off * a * np.cos(phi)
                ha = max(3, int(min(a, b) * rng.uniform(0.25, 0.5)))
                cuts.append((hy, hx, ha, max(3, int(ha * rng.uniform(0.6, 1.0))),
                             rng.uniform(0, np.pi), 2.0))

    # nearest-surface depth over the union of parts
    z_obj = rng.uniform(lo + 0.06 * span, lo + 0.42 * span)
    obj_depth = np.full((h, w), np.inf, np.float32)
    rr_all = np.zeros((h, w), np.float32)
    for i, part in enumerate(parts):
        m = _superellipse(ys, xs, *part)
        if not m.any():
            continue
        rr = _radial(ys, xs, *part)
        # lobes sit within +-4% span of the base slab; nearer surface wins
        z_p = z_obj + (0.0 if i == 0 else rng.uniform(-0.04, 0.04) * span)
        bump = np.sqrt(rr) * rng.uniform(0.01, 0.05) * span
        obj_depth = np.where(m, np.minimum(obj_depth, z_p - bump), obj_depth)
        rr_all = np.maximum(rr_all, rr)
    mask = np.isfinite(obj_depth)
    for cut in cuts:
        cut_m = _superellipse(ys, xs, *cut)
        mask &= ~cut_m
    if not mask.any():
        return None
    obj_depth = np.where(mask, obj_depth, np.inf)

    albedo = rng.randint(90, 255, 3).astype(np.float32)
    tex, _ = _texture(rng, h, w, ys, xs, albedo,
                      kind=None if shapes != "convex" else "plain")
    shade = (0.8 + 0.4 * rr_all)[..., None]
    obj_rgb = tex * shade + rng.randn(h, w, 3) * rng.uniform(2, 10)
    return mask, obj_depth, obj_rgb


def render_scene(
    rng: np.random.RandomState,
    h: int,
    w: int,
    depth_range=(2500.0, 15000.0),
    n_objects=None,
    dropout_frac: float = 0.0,
    return_amodal: bool = False,
    shapes: str = "mixed",
):
    """Render one scene.

    Returns (rgb uint8 [h,w,3], depth_mm float32 [h,w], masks uint8 [n,h,w]).
    Masks are visible regions only (later = nearer objects occlude earlier
    ones); fully-occluded objects are dropped. With `return_amodal`, a
    fourth array of the full (pre-occlusion) masks per kept object is
    appended (amodal ground truth). Holes/bites are part of
    the object's true silhouette, so they stay cut out of the amodal mask.
    `shapes` selects the silhouette vocabulary: "convex" (single
    superellipses), "mixed" (composites: thin bars, extra lobes, boundary
    bites, interior holes that expose the table) or "concave" (every object
    gets a concave feature).
    """
    assert shapes in ("convex", "mixed", "concave"), shapes
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    lo, hi = float(depth_range[0]), float(depth_range[1])
    span = hi - lo

    # background: tilted plane with mild large-scale ripple + speckle
    gy, gx = rng.uniform(-0.12, 0.12), rng.uniform(-0.12, 0.12)
    base = rng.uniform(lo + 0.55 * span, lo + 0.8 * span)
    depth = base + gy * span * (ys / h - 0.5) + gx * span * (xs / w - 0.5)
    depth += 0.004 * span * np.sin(ys / h * rng.uniform(2, 5) * np.pi + rng.rand() * 6)
    table_albedo = rng.randint(30, 110, 3).astype(np.float32)
    if shapes == "convex":
        table_rgb = np.broadcast_to(table_albedo, (h, w, 3)).copy()
    else:
        # textured table: color edges that are NOT object boundaries
        table_rgb, _ = _texture(rng, h, w, ys, xs, table_albedo)
    table_rgb = table_rgb + rng.randn(h, w, 3) * rng.uniform(2, 8)
    # low-frequency table shading
    table_rgb = table_rgb * (0.85 + 0.3 * (xs / w) * rng.rand())[..., None]
    rgb = table_rgb

    if n_objects is None:
        n_objects = rng.randint(3, 9)
    r_hi = max(14, min(h, w) // 5)
    r_lo = max(8, min(h, w) // 14)

    label = np.zeros((h, w), np.int32)
    scene_depth_obj = np.full((h, w), np.inf, np.float32)
    keep_ids = []
    full_masks = {}
    for k in range(1, n_objects + 1):
        obj = _render_object(rng, ys, xs, h, w, lo, span, r_lo, r_hi, shapes)
        if obj is None:
            continue
        m, obj_depth, obj_rgb = obj
        depth = np.where(m, obj_depth, depth)
        rgb = np.where(m[..., None], obj_rgb, rgb)
        label = np.where(m, k, label)  # later object wins = occludes
        scene_depth_obj = np.where(m, obj_depth, scene_depth_obj)
        keep_ids.append(k)
        full_masks[k] = m

    masks, amodal = [], []
    for k in keep_ids:
        vis = label == k
        if vis.sum() >= 24:  # drop (nearly) fully-occluded objects
            masks.append(vis.astype(np.uint8))
            amodal.append(full_masks[k].astype(np.uint8))
    if not masks:  # degenerate scene: force one central object
        m = _superellipse(ys, xs, h // 2, w // 2, r_hi, r_hi, 0.0, 2.0)
        depth = np.where(m, lo + 0.2 * span, depth)
        rgb = np.where(m[..., None], np.float32([200, 80, 80]), rgb)
        masks = [m.astype(np.uint8)]
        amodal = [m.astype(np.uint8)]

    if dropout_frac > 0:
        # sensor dropout blobs: zero depth at object boundaries + speckle
        drop = rng.rand(h, w) < dropout_frac
        depth = np.where(drop, 0.0, depth)

    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if return_amodal:
        return (rgb, depth.astype(np.float32), np.asarray(masks, np.uint8),
                np.asarray(amodal, np.uint8))
    return rgb, depth.astype(np.float32), np.asarray(masks, np.uint8)


def synthetic_records(
    n: int,
    h: int,
    w: int,
    seed: int = 0,
    depth_range=(2500, 15000),
    target_iou=(0.7, 0.95),
    dropout_frac: float = 0.0,
    n_objects=None,
    shapes: str = "mixed",
):
    """In-memory dataset records (the --synthetic data source of the
    trainer): rendered scene, visible GT masks and RLE-coded perturbed masks.
    `n_objects` is an optional (lo, hi) range sampled per scene (default: the
    renderer's 3-8)."""
    from quber_tpu_torch.data import rle
    from quber_tpu_torch.data.perturb import perturb_masks

    rng = np.random.RandomState(seed)
    records = []
    for _ in range(n):
        n_obj = (rng.randint(n_objects[0], n_objects[1] + 1)
                 if n_objects else None)
        rgb, depth, masks = render_scene(rng, h, w, depth_range,
                                         dropout_frac=dropout_frac,
                                         n_objects=n_obj, shapes=shapes)
        pert = perturb_masks(masks, rng, target_iou=target_iou)
        records.append({
            "gt_masks": masks,
            "perturbed_segmentation": [rle.encode(m) for m in pert],
            "height": h, "width": w,
            "rgb": rgb,
            "depth_mm": depth,
        })
    return records
