"""MaskRefinerPredictor: refinement inference (torch), one frame or a batch.

Port of quber_tpu/predictor.py:
  * single frame (:227, :396-511, :1490-1547): `predict`, `predict_raw`:
    mask encoding -> dual-trunk backbone -> hierarchical heads -> centre
    NMS -> pixel grouping -> merge and score;
  * batched and streamed serving in the dense input layout (:513-538,
    :946-1009, :1081-1090, :1160-1200, :1231-1488): `predict_batch`,
    `stage_frames`, `predict_batch_stream_staged`, `predict_batch_stream`
    and the double-buffered single-frame `predict_stream`;
  * `MultiScalePredictor` (:1550-1651).
Encoding and grouping go through the CUDA kernels of ops/kernels.py on the
card (the batched entry points launch each batched kernel once per batch),
and through their plain versions when the predictor runs on the CPU
(device="cpu").

The serving entry points take the reference's packed input contract: each
frame is (rgb [H, W, 3] uint8 BGR, depth [H, W, 3] or [H, W], masks [N, H,
W]); only channel 0 of depth travels, cast to uint8, and is replicated to
3 channels on the device; a mask pixel is set where it is > 0; only the
masks handed in are valid. Each frame gives (panoptic [H, W] int32, count,
scores float32 [top_k_instances + 2]). Panoptic ids are returned as they
are: the reference's bit-plane output keeps (max_instances + 1).bit_length()
bits of each id, the port all of them. The reference's packed, RLE and
codec wire formats and its H2D stream tuner are not ported (ROADMAP item
15).

Mesh serving (`mesh=`, a parallel.mesh.Mesh of D in-process devices; the
dense-input counterpart of the reference's sharded_batch_pipeline, :1092):
one model replica a mesh device, each with its own copy, compute and D2H
streams; each batch is split into D contiguous sub-batches, each uploaded,
refined and read back on its replica's streams, and the frames come back in
input order, equal to predict_batch's. A mesh may name one device twice:
two replicas then share it (how one card serves, and tests, two).

Float32 throughout: on the card, TF32 is switched off for convolutions and
matrix products (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32, process-wide) when a CUDA
predictor is built, so that the port computes what the float32 reference
computes.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import queue
import threading

import numpy as np
import torch
import torch.nn.functional as F

from quber_tpu_torch.data.mappers import bucket_shape, resize, resize_shortest_edge
from quber_tpu_torch.models.from_jax import as_state_dict
from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig
from quber_tpu_torch.ops import kernels
from quber_tpu_torch.ops.grouping import find_instance_centers_batched, merge_and_score
from quber_tpu_torch.parallel.mesh import split_batch

_END = object()


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> XYXY boxes [N, 4] (detectron2 BitMasks convention)."""
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.where(m)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


def _batches(frames, batch_size: int):
    """Lists of up to batch_size frames, consuming `frames` lazily."""
    batch = []
    for frame in frames:
        batch.append(frame)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def _images(img4: torch.Tensor) -> torch.Tensor:
    """uint8 RGB-D [B, H, W, 4] -> float32 [B, 6, H, W]: RGB, then the depth
    channel replicated 3 times (the reference's _unpack_buf)."""
    x = img4.permute(0, 3, 1, 2).float()
    return torch.cat([x[:, :3], x[:, 3:].expand(-1, 3, -1, -1)], dim=1)


class MaskRefinerPredictor:
    """Refinement predictor.

    Args:
      config: model + post-processing configuration (default: flagship).
      params: flax-layout variable tree of numpy arrays, carried across
        with models.from_jax, or a torch state dict (either as
        train.checkpoint.load_eval_params returns it); None
        random-initialises from `seed`.
      max_instances: the most initial masks a frame may hand in.
      device: "cuda" (default) or "cpu".

    `sync_events`: set it to a list to have each batch's host sync (the
    batch-wide fast-K branch) append a pair of CUDA events around it; the
    time between them is device time the compute stream spends idle.
    """

    def __init__(self, config: MaskRefinerConfig | None = None, params=None,
                 max_instances: int = 64, seed: int = 0, device="cuda"):
        self.config = config or MaskRefinerConfig()
        self.max_instances = max_instances
        self.device = torch.device(device)
        self.sync_events = None
        # a mesh replica's own compute stream (_replicas); the predictor's
        # work goes on the current stream
        self._copy_stream = self._d2h_stream = self._compute_stream = None
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            self._copy_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
        model = MaskRefiner(self.config)
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(as_state_dict(params), strict=True)
        self.model = model.to(self.device).eval()

    def _encode(self, masks, valid):
        """Initial-mask encoding: the statistics kernel, then the encode kernel."""
        _, centers, ok = kernels.instance_stats(masks, valid, return_ok=True)
        return kernels.encode_initial_masks(masks, ok, centers, sigma=10, normalize=True)

    def _heads(self, out):
        """Model outputs [B, ...] -> the batch's pre-grouping dict: foreground
        probability, centre map, offsets and the NMS'd centres per frame."""
        cfg = self.config
        fg_logit = out["foreground"][:, 0]
        fg_prob = torch.sigmoid(fg_logit)
        center = out["center"][:, 0]
        centers, cvalid = find_instance_centers_batched(
            center, cfg.center_threshold, cfg.nms_kernel, cfg.top_k_instances)
        pre = {
            "sem_seg": fg_logit,
            "fg_prob": fg_prob,
            "fg_bin": torch.round(fg_prob).to(torch.int32),
            "center": center,
            "offset": out["offset"],
            "centers": centers,
            "centers_valid": cvalid,
        }
        for k in ("eee_mask", "eee_boundary"):
            if k in out:
                pre[k] = out[k]
        return pre

    def _pre(self, image, masks, valid):
        """Everything before pixel grouping: encode -> forward -> centre NMS."""
        enc = self._encode(masks, valid)
        pre = self._heads(self.model(image.permute(2, 0, 1)[None], enc[None]))
        return {k: v[0] for k, v in pre.items()}

    def _pre_batch(self, images, masks, valids):
        """Batched pre stages (reference :946-967): one statistics and one
        encode launch for the batch, one forward over images [B, 6, H, W],
        batched centre NMS."""
        _, centers, ok = kernels.instance_stats(masks, valids, return_ok=True)
        enc = kernels.encode_initial_masks_batched(masks, ok, centers,
                                                   sigma=10, normalize=True)
        return self._heads(self.model(images, enc))

    def _post(self, pre, raw):
        cfg = self.config
        pano = merge_and_score(
            pre["fg_bin"], pre["fg_prob"], pre["center"], raw, pre["centers_valid"],
            min_instance_area=cfg.min_instance_area, stuff_area=cfg.stuff_area)
        result = {
            "sem_seg": pre["sem_seg"],
            "center": pre["center"],
            "offset": pre["offset"],
            "panoptic_seg": pano["panoptic"],
            "num_instances": pano["num_instances"],
            "instance_scores": pano["scores"],
        }
        for k in ("eee_mask", "eee_boundary"):
            if k in pre:
                result[k] = pre[k]
        return result

    def _adaptive_fast_k(self):
        """K of the adaptive grouping fast path, or None when it is off."""
        cfg = self.config
        if not cfg.fast_top_k or cfg.fast_top_k >= cfg.top_k_instances:
            return None
        return cfg.fast_top_k

    def _group_and_post(self, pre):
        """Pixel grouping + merge/score at K = fast_top_k when the survivors
        fit (they come first, so the slice keeps them all), else at
        top_k_instances. The branch reads the survivor count on the host:
        one device sync per frame."""
        fk = self._adaptive_fast_k()
        if fk is None or int(pre["centers_valid"].sum()) > fk:
            raw = kernels.group_pixels(pre["centers"], pre["centers_valid"], pre["offset"])
            return self._post(pre, raw)
        pre_s = dict(pre, centers=pre["centers"][:fk],
                     centers_valid=pre["centers_valid"][:fk])
        raw = kernels.group_pixels(pre_s["centers"], pre_s["centers_valid"], pre["offset"])
        out = self._post(pre_s, raw)
        out["instance_scores"] = F.pad(
            out["instance_scores"], (0, self.config.top_k_instances - fk))
        return out

    def _batch_k(self, cvalid):
        """K the batch groups at (reference :513-538): fast_top_k when every
        frame's survivors fit, else top_k_instances, so one crowded frame
        sends the whole batch to the top_k path. The choice reads the
        largest survivor count on the host, one device sync per batch,
        where the reference branches on the device with lax.cond."""
        fk = self._adaptive_fast_k()
        if fk is None:
            return self.config.top_k_instances
        n_max = cvalid.sum(dim=1).max()
        if self.sync_events is None or self.device.type != "cuda":
            fits = int(n_max) <= fk
        else:
            waits, resumes = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            waits.record()
            fits = int(n_max) <= fk
            resumes.record()
            self.sync_events.append((waits, resumes))
        return fk if fits else self.config.top_k_instances

    def _group_and_post_batch(self, pre):
        """Batched grouping (one kernel launch) + merge/score frame by frame
        -> (panoptic [B, H, W] int32, counts [B] int32, scores [B, top_k + 2]
        f32, zero-padded past the K grouped at)."""
        cfg = self.config
        k = self._batch_k(pre["centers_valid"])
        centers = pre["centers"][:, :k].contiguous()
        cvalid = pre["centers_valid"][:, :k].contiguous()
        raw = kernels.group_pixels_batched(centers, cvalid, pre["offset"].contiguous())
        pans, counts, scores = [], [], []
        for i in range(raw.shape[0]):
            pano = merge_and_score(
                pre["fg_bin"][i], pre["fg_prob"][i], pre["center"][i], raw[i], cvalid[i],
                min_instance_area=cfg.min_instance_area, stuff_area=cfg.stuff_area)
            pans.append(pano["panoptic"])
            counts.append(pano["num_instances"])
            scores.append(pano["scores"])
        scores = F.pad(torch.stack(scores), (0, cfg.top_k_instances - k))
        return torch.stack(pans), torch.stack(counts), scores

    # ------------------------------------------------------------------
    # Batched and streamed serving (dense layout)
    # ------------------------------------------------------------------

    def _assemble(self, frames, batch_size: int, pin: bool | None = None):
        """Host side of a batch, the reference's _pack_batch (:1160-1200) in
        its dense layout: uint8 RGB-D [B, H, W, 4], masks [B, N, H, W] bool
        and valid [B, N] bool, in pinned memory when the predictor is on the
        card. N is the batch's largest mask count (an invalid slot changes
        no output). A partial batch is padded with copies of its first
        frame. Returns ((img4, masks, valid), real)."""
        cfg = self.config
        pin = self.device.type == "cuda" if pin is None else pin
        h, w = cfg.height, cfg.width
        real = len(frames)
        frames = list(frames) + [frames[0]] * (batch_size - real)
        counts = [min(len(f[2]), self.max_instances) for f in frames]
        n = max(counts)
        img4 = torch.empty((batch_size, h, w, 4), dtype=torch.uint8, pin_memory=pin)
        masks = torch.empty((batch_size, n, h, w), dtype=torch.bool, pin_memory=pin)
        valid = torch.zeros((batch_size, n), dtype=torch.bool, pin_memory=pin)
        img_np, masks_np, valid_np = img4.numpy(), masks.numpy(), valid.numpy()
        for b, ((rgb, depth, fmasks), count) in enumerate(zip(frames, counts)):
            rgb, depth = np.asarray(rgb), np.asarray(depth)
            if rgb.shape[:2] != (h, w):
                raise ValueError(f"predictor is configured for {h}x{w}, "
                                 f"got {rgb.shape[0]}x{rgb.shape[1]}")
            img_np[b, ..., :3] = np.asarray(rgb, np.uint8)
            img_np[b, ..., 3] = np.asarray(depth[..., 0] if depth.ndim == 3 else depth,
                                           np.uint8)
            if count:
                masks_np[b, :count] = np.asarray(fmasks[:count]) > 0
            masks_np[b, count:] = False
            valid_np[b, :count] = True
        return (img4, masks, valid), real

    def _upload(self, tensors):
        """H2D on the current stream (non-blocking from pinned memory). The
        pinned blocks go back to the host allocator's cache only once the
        copy that reads them has completed."""
        return tuple(t.to(self.device, non_blocking=True) for t in tensors)

    def _uploaded_batches(self, frames, batch_size: int, stream=None):
        """Assemble batches of `frames` (consumed lazily) and upload each, on
        `stream` when given (then with the event of its copy) or on the
        current stream. Yields (tensors, ready event or None, real)."""
        for batch in _batches(frames, batch_size):
            tensors, real = self._assemble(batch, batch_size)
            if stream is None:
                yield self._upload(tensors), None, real
                continue
            with torch.cuda.stream(stream):
                tensors = self._upload(tensors)
                ready = torch.cuda.Event()
                ready.record(stream)
            yield tensors, ready, real

    def _to_host(self, outs):
        """D2H of a batch's outputs on the D2H stream, after the work the
        compute stream has enqueued: the next batch computes meanwhile.
        Returns (host tensors, event of the copy, or None on the CPU)."""
        if self.device.type != "cuda":
            return outs, None
        compute = torch.cuda.current_stream(self.device)
        d2h = self._d2h_stream
        d2h.wait_stream(compute)
        with torch.cuda.stream(d2h):
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in outs)
            done = torch.cuda.Event()
            done.record(d2h)
        for t in outs:
            t.record_stream(d2h)
        return host, done

    def _dispatch(self, tensors, ready, real):
        """Enqueue one device-resident batch on the current (compute) stream.
        `ready` is the event of its H2D on the copy stream, or None when the
        tensors are resident already or were copied on this stream."""
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in tensors:
                t.record_stream(compute)
        img4, masks, valid = tensors
        with torch.inference_mode():
            outs = self._group_and_post_batch(self._pre_batch(_images(img4), masks, valid))
        host, done = self._to_host(outs)
        return host, done, real

    @staticmethod
    def _drain(pending):
        """Blocking readback of one dispatched batch: its `real` frames."""
        (pan, count, scores), done, real = pending
        if done is not None:
            done.synchronize()
        for i in range(real):
            yield pan[i].numpy().copy(), int(count[i]), scores[i].numpy().copy()

    @staticmethod
    def _serve(batches, prefetch: int):
        """Dispatch batches, each a list of (predictor, tensors, ready, real)
        parts (the batch itself, or a mesh's sub-batches each on its
        replica's compute stream), up to `prefetch` batches ahead of the
        blocking readback; yield per-frame results in input order."""
        pending = collections.deque()
        for parts in batches:
            dispatched = []
            for rep, tensors, ready, real in parts:
                with rep._on_compute():
                    dispatched.append((rep, rep._dispatch(tensors, ready, real)))
            pending.append(dispatched)
            if len(pending) > prefetch:
                for rep, p in pending.popleft():
                    yield from rep._drain(p)
        while pending:
            for rep, p in pending.popleft():
                yield from rep._drain(p)

    # ------------------------------------------------------------------
    # Mesh serving: one replica a mesh device
    # ------------------------------------------------------------------

    def _replicas(self, mesh) -> list:
        """The mesh's replicas (made once a mesh): a predictor each, with a
        copy of the module on its device and streams of its own."""
        cache = self.__dict__.setdefault("_mesh_replicas", {})
        if id(mesh) not in cache:
            replicas = []
            for dev in mesh.devices:
                rep = copy.copy(self)
                rep.__dict__.pop("_mesh_replicas", None)
                rep.device = torch.device(dev)
                rep.model = copy.deepcopy(self.model).to(rep.device)
                if rep.device.type == "cuda":
                    rep._copy_stream, rep._d2h_stream, rep._compute_stream = (
                        torch.cuda.Stream(rep.device) for _ in range(3))
                replicas.append(rep)
            cache[id(mesh)] = (mesh, replicas)  # the mesh is held: its id stays its own
        return cache[id(mesh)][1]

    def _on_compute(self):
        """The replica's compute stream as the current stream (nothing on the
        CPU)."""
        stream = self._compute_stream
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _mesh_parts(self, mesh, batch_size: int):
        replicas = self._replicas(mesh)
        if batch_size % len(replicas):
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"{len(replicas)}-device mesh")
        return replicas, batch_size // len(replicas)

    def _uploaded_mesh_batches(self, frames, batch_size: int, mesh):
        """Assemble batches of `frames` (consumed lazily), split each into the
        mesh's sub-batches and upload each on its replica's copy stream.
        Yields a list of (replica, tensors, ready event or None, real) a
        batch."""
        replicas, sub = self._mesh_parts(mesh, batch_size)
        pin = any(r.device.type == "cuda" for r in replicas)
        for batch in _batches(frames, batch_size):
            tensors, real = self._assemble(batch, batch_size, pin)
            parts = []
            for i, (rep, part) in enumerate(zip(replicas, split_batch(tensors, mesh))):
                n = min(max(real - i * sub, 0), sub)
                if rep._copy_stream is None:
                    parts.append((rep, rep._upload(part), None, n))
                    continue
                with torch.cuda.stream(rep._copy_stream):
                    part = rep._upload(part)
                    ready = torch.cuda.Event()
                    ready.record(rep._copy_stream)
                parts.append((rep, part, ready, n))
            yield parts

    def predict_batch(self, frames):
        """Refine a list of (rgb, depth, masks) frames as one batch (one
        launch of each batched kernel, one forward). Returns a list of
        (panoptic [H, W] int32, count, scores [top_k + 2] f32)."""
        frames = list(frames)
        tensors, real = self._assemble(frames, len(frames))
        return list(self._serve([[(self, self._upload(tensors), None, real)]], prefetch=0))

    def stage_frames(self, frames, batch_size: int = 8, mesh=None):
        """Device-resident dense batches for predict_batch_stream_staged, so
        that serving pays no H2D (the reference's stage_frames with
        decode=True). The copies run on a side stream and are fenced before
        this returns. Returns a list of ((img4, masks, valid), real); with a
        `mesh`, of (the sub-batches on their replicas' devices, real), for
        predict_batch_stream_staged with the same mesh."""
        if mesh is not None:
            staged = []
            for parts in self._uploaded_mesh_batches(frames, batch_size, mesh):
                staged.append(([t for _, t, _, _ in parts], sum(n for *_, n in parts)))
            for rep in self._replicas(mesh):
                if rep._copy_stream is not None:
                    rep._copy_stream.synchronize()
            for parts, _ in staged:
                for rep, tensors in zip(self._replicas(mesh), parts):
                    if rep._compute_stream is not None:
                        for t in tensors:
                            t.record_stream(rep._compute_stream)
            return staged
        side = self._copy_stream
        staged = [(tensors, real) for tensors, _, real
                  in self._uploaded_batches(frames, batch_size, side)]
        if side is not None:
            side.synchronize()
            compute = torch.cuda.current_stream(self.device)
            for tensors, _ in staged:
                for t in tensors:
                    t.record_stream(compute)
        return staged

    def predict_batch_stream_staged(self, staged, prefetch: int = 2, mesh=None):
        """Serve batches from stage_frames, dispatching up to `prefetch`
        batches ahead of the blocking readback. Yields (panoptic, count,
        scores) for the real frames of each batch, in order. With a `mesh`
        (the one stage_frames was given), each sub-batch runs on its
        replica."""
        if mesh is None:
            yield from self._serve(([(self, t, None, real)] for t, real in staged), prefetch)
            return
        replicas = self._replicas(mesh)

        def batches():
            for parts, real in staged:
                if len(parts) != len(replicas):
                    raise ValueError("the batches were not staged for this mesh")
                sub = len(parts[0][0])
                yield [(rep, t, None, min(max(real - i * sub, 0), sub))
                       for i, (rep, t) in enumerate(zip(replicas, parts))]

        yield from self._serve(batches(), prefetch)

    def predict_batch_stream(self, frames, batch_size: int = 8, prefetch: int = 2, mesh=None):
        """Stream frames in fixed-size batches (the last partial batch is
        padded with its first frame) and yield (panoptic, count, scores) per
        frame, in order.

        A producer thread consumes `frames` lazily, fills pinned host
        batches and copies them to the device on a copy stream, up to
        `prefetch` batches ahead; the compute stream waits on each batch's
        copy event, and each batch's outputs go back on a D2H stream while
        the next batch computes. An exception raised by `frames` is raised
        here; closing the generator stops the producer. `prefetch=0` runs
        everything inline. With a `mesh` of D devices, each batch is split
        into D sub-batches served by the mesh's replicas (batch_size must
        divide by D)."""
        def uploaded():
            if mesh is not None:
                return self._uploaded_mesh_batches(frames, batch_size, mesh)
            stream = self._copy_stream if prefetch > 0 else None
            return ([(self, *item)] for item in self._uploaded_batches(frames, batch_size, stream))

        if mesh is not None:
            self._mesh_parts(mesh, batch_size)  # raises before any frame is read
        if prefetch <= 0:
            yield from self._serve(uploaded(), 0)
            return

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False  # the consumer abandoned the generator

        def producer():
            try:
                for item in uploaded():
                    if not put(item):
                        return
                put(_END)
            except Exception as e:  # raised again in the consumer
                put(e)

        def batches():
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            yield from self._serve(batches(), prefetch)
        finally:
            stop.set()
            thread.join(timeout=5.0)

    def predict_stream(self, frames):
        """Single-frame serving with double buffering: frame t+1's upload
        and compute are enqueued before frame t's results are read back.
        Same input contract and per-frame outputs as predict_batch_stream;
        runs the single-frame kernels."""
        prev = None
        for (img4, masks, valid), _, _ in self._uploaded_batches(frames, 1):
            with torch.inference_mode():
                image = _images(img4)[0].permute(1, 2, 0)
                out = self._group_and_post(self._pre(image, masks[0], valid[0]))
            outs = (out["panoptic_seg"][None], out["num_instances"][None],
                    out["instance_scores"][None])
            cur = (*self._to_host(outs), 1)
            if prev is not None:
                yield from self._drain(prev)
            prev = cur
        if prev is not None:
            yield from self._drain(prev)

    # ------------------------------------------------------------------
    # Single frame
    # ------------------------------------------------------------------

    def _assemble_image(self, rgb_img, depth_img):
        cfg = self.config
        chans = []
        if cfg.rgb_on:
            chans.append(np.asarray(rgb_img, np.float32))
        if cfg.depth_on:
            chans.append(np.asarray(depth_img, np.float32))
        return np.concatenate(chans, axis=-1)

    @torch.inference_mode()
    def predict_raw(self, rgb_img, depth_img, perturbed_masks):
        """Result dict of tensors on the predictor's device. Inputs: rgb_img
        [H, W, 3] BGR uint8; depth_img [H, W, 3] normalised depth;
        perturbed_masks [N, H, W] (bool or uint8). Only the masks handed in
        travel to the device; slots past them would be invalid, and an
        invalid slot changes no output, so none are padded on."""
        cfg = self.config
        image = self._assemble_image(rgb_img, depth_img)
        h, w = image.shape[:2]
        if (h, w) != (cfg.height, cfg.width):
            raise ValueError(f"predictor is configured for {cfg.height}x{cfg.width}, "
                             f"got {h}x{w}")
        count = min(len(perturbed_masks), self.max_instances)
        masks = np.zeros((count, h, w), bool)
        for i in range(count):
            masks[i] = np.asarray(perturbed_masks[i]) > 0
        dev = self.device
        masks_t = torch.from_numpy(masks).to(dev)
        valid_t = torch.ones((count,), dtype=torch.bool, device=dev)
        image_t = torch.from_numpy(image).to(dev)
        return self._group_and_post(self._pre(image_t, masks_t, valid_t))

    def predict(self, rgb_img, depth_img=None, perturbed_masks=None):
        """Reference-compatible predict: a list with one result dict holding
        'sem_seg', 'eee_mask', 'eee_boundary', 'panoptic_seg' and, when any
        instance survives, 'instances' with pred_masks / scores /
        pred_classes / pred_boxes."""
        if perturbed_masks is None:
            perturbed_masks = []
        raw = self.predict_raw(rgb_img, depth_img, perturbed_masks)
        pan = raw["panoptic_seg"].cpu().numpy()
        n = int(raw["num_instances"])
        out = {
            "sem_seg": raw["sem_seg"].cpu().numpy(),
            "panoptic_seg": (pan, None),
        }
        for k in ("eee_mask", "eee_boundary"):
            if k in raw:
                out[k] = raw[k].cpu().numpy()
        if n > 0:
            masks = pan[None] == np.arange(1, n + 1)[:, None, None]
            out["instances"] = {
                "pred_masks": masks,
                "scores": raw["instance_scores"].cpu().numpy()[1:n + 1],
                "pred_classes": np.zeros((n,), np.int64),
                "pred_boxes": masks_to_boxes(masks),
            }
        return [out]


class MultiScalePredictor:
    """Arbitrary-resolution predict via ResizeShortestEdge + shape buckets
    (reference :1550-1651): the shorter side is scaled to `short` (the
    longer capped at `max_size`), padded up to a /`divisor` bucket, refined
    by that bucket's predictor, and the outputs are cropped and resized
    back to the input size. Every bucket shares the one MaskRefiner module
    on the device; a new bucket costs a predictor object, not a weight
    upload. Resizing runs with torch on the predictor's device
    (data.mappers.resize), not with OpenCV.
    """

    def __init__(self, config: MaskRefinerConfig | None = None, params=None,
                 short: int = 480, max_size: int = 640, divisor: int = 32,
                 **predictor_kwargs):
        self.base_cfg = config or MaskRefinerConfig()
        self.short = short
        self.max_size = max_size
        self.divisor = divisor
        proto = MaskRefinerPredictor(self.base_cfg, params=params, **predictor_kwargs)
        self._cache = {(self.base_cfg.height, self.base_cfg.width): proto}

    def _predictor_for(self, ph: int, pw: int) -> MaskRefinerPredictor:
        key = (ph, pw)
        if key not in self._cache:
            pred = copy.copy(next(iter(self._cache.values())))  # shares the module
            pred.config = dataclasses.replace(self.base_cfg, height=ph, width=pw)
            self._cache[key] = pred
        return self._cache[key]

    @property
    def num_buckets(self) -> int:
        return len(self._cache)

    def predict(self, rgb_img, depth_img=None, perturbed_masks=None):
        rgb_img = np.asarray(rgb_img)
        h0, w0 = rgb_img.shape[:2]
        rh, rw = resize_shortest_edge(h0, w0, self.short, self.max_size)
        ph, pw = bucket_shape(rh, rw, self.divisor)
        pred = self._predictor_for(ph, pw)
        dev = pred.device

        def to_bucket(img, interp):
            img = np.asarray(img)
            if img.shape[:2] != (rh, rw):
                img = resize(img, (rh, rw), interp, dev)
            pads = [(0, ph - rh), (0, pw - rw)] + [(0, 0)] * (img.ndim - 2)
            return np.pad(img, pads)

        rgb_b = to_bucket(rgb_img, "linear")
        depth_b = (to_bucket(depth_img, "nearest") if depth_img is not None
                   else np.zeros((ph, pw, 3), np.float32))
        masks_b = [to_bucket((np.asarray(m) > 0).astype(np.uint8), "nearest") > 0.5
                   for m in ([] if perturbed_masks is None else perturbed_masks)]
        out = pred.predict(rgb_b, depth_b, masks_b)[0]

        def back(arr, interp, channels_first=False):
            arr = np.asarray(arr, np.float32)
            if channels_first:  # [C, H, W] (reference sem-seg layout)
                arr = np.transpose(arr, (1, 2, 0))
            arr = resize(arr[:rh, :rw], (h0, w0), interp, dev)
            return np.transpose(arr, (2, 0, 1)) if channels_first else arr

        pan = back(out["panoptic_seg"][0], "nearest").astype(np.int32)
        res = {"sem_seg": back(out["sem_seg"], "linear"), "panoptic_seg": (pan, None)}
        for k in ("eee_mask", "eee_boundary"):
            if k in out:
                res[k] = back(out[k], "linear", channels_first=True)
        if "instances" in out:
            n = len(out["instances"]["scores"])
            masks = pan[None] == np.arange(1, n + 1)[:, None, None]
            keep = masks.any(axis=(1, 2))
            masks = masks[keep]
            res["instances"] = {
                "pred_masks": masks,
                "scores": out["instances"]["scores"][keep],
                "pred_classes": np.zeros((len(masks),), np.int64),
                "pred_boxes": masks_to_boxes(masks),
            }
        return [res]
