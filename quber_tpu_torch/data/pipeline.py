"""The worker loader of training: records mapped in a pool of worker
processes, in the order of the in-process iterator.

Port of quber_tpu/data/pipeline.py (grain's shuffle, repeat, map, batch and
mp_prefetch) in the idiom of the standard library: a `spawn` pool of
`worker_count` processes, each holding a copy of the mapper, maps the
records in the order data/mappers.batch_iterator visits them (a
RandomState(seed) shuffle redrawn every epoch), at most `prefetch` samples
a worker ahead of the consumer; the main process stacks them into batches,
grouped by shape as batch_iterator groups them (a multi-scale mapper's
buckets never mix in a batch). So with the augmentation off, the batches
equal batch_iterator's. With it on, each sample's draws come from a
RandomState seeded by (seed, its position in the stream), so a run is
reproducible whatever the workers' scheduling, though not equal to the
in-process iterator's, whose mapper draws from one stream. Copy-paste is
refused: its donor is the sample that the same mapper mapped last, which in
a pool is whichever the scheduler gave that worker (ROADMAP item 11d). With
worker_count 0 this is batch_iterator itself. The workers start with
`spawn`, which imports the caller's main module again: a script that
makes a loader must guard its entry with `if __name__ == "__main__":`.

Data parallel (`shard=(rank, world)`): each rank follows the same stream of
positions, cut into global batches of `batch_size`, and maps only its own
contiguous 1/world of each, with the position-seeded draws (in the worker
pool or, at worker_count 0, in process); so the ranks' batches are the
single-process worker loader's batches, sliced. A rank cannot see the
shapes of the samples it does not map, so a multi-scale mapper, whose
batches are grouped by shape, is refused there.
"""

from __future__ import annotations

import multiprocessing as mp
from collections import deque

import numpy as np

_WORKER: dict = {}


def _init_worker(mapper, records, seed):
    import torch

    torch.set_num_threads(1)
    _WORKER.update(mapper=mapper, records=records, seed=seed)


def _map_one(pos: int, index: int, worker: dict | None = None) -> dict:
    worker = _WORKER if worker is None else worker
    mapper = worker["mapper"]
    if hasattr(mapper, "rng"):
        mapper.rng = np.random.RandomState([worker["seed"] % 2 ** 32, pos % 2 ** 32])
    return mapper(worker["records"][index])


def _order(n: int, shuffle: bool, seed: int):
    """Record indices in batch_iterator's order, endlessly."""
    rng = np.random.RandomState(seed)
    order = np.arange(n)
    while True:
        if shuffle:
            rng.shuffle(order)
        yield from (int(i) for i in order)


class _Done:
    """An in-process result with the AsyncResult's get()."""

    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


class WorkerLoader:
    """Iterator of stacked numpy batch dicts (endless); `close()` stops the
    workers (also on garbage collection and at the end of a `with`). With
    `shard=(rank, world)` each batch is this rank's slice of the global
    batch of `batch_size`; worker_count 0 then maps in process."""

    def __init__(self, records, mapper, batch_size: int, seed: int = 0, shuffle: bool = True,
                 worker_count: int = 2, prefetch: int = 2, shard: tuple | None = None):
        from quber_tpu_torch.data.datasets import get_dataset

        self._pool = None
        self._closed = False
        if getattr(mapper, "is_train", False) and getattr(getattr(mapper, "tc", None),
                                                          "copy_paste_prob", 0.0) > 0:
            raise ValueError("copy-paste takes its donor from the sample a mapper mapped "
                             "last, which worker processes would make depend on their "
                             "scheduling; train with copy_paste_prob > 0 at --workers 0 "
                             "(worker-loader copy-paste is ROADMAP item 11d)")
        self.records = get_dataset(records) if isinstance(records, str) else list(records)
        rank, world = shard or (0, 1)
        if batch_size % world:
            raise ValueError(f"the global batch of {batch_size} does not divide over "
                             f"{world} ranks")
        self.batch_size = batch_size // world
        self._global, self._rank, self._sharded = batch_size, rank, shard is not None
        if worker_count:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(worker_count, initializer=_init_worker,
                                  initargs=(mapper, self.records, seed))
        self._local = dict(mapper=mapper, records=self.records, seed=seed)
        self._indices = _order(len(self.records), shuffle, seed)
        self._pos = 0
        self._inflight: deque = deque()
        self._depth = max(1, worker_count * prefetch)
        self._pending: dict = {}

    def _next_position(self) -> tuple[int, int]:
        """(stream position, record index) of the next sample this rank maps."""
        while True:
            pos, index = self._pos, next(self._indices)
            self._pos += 1
            if pos % self._global // self.batch_size == self._rank:
                return pos, index

    def _submit(self):
        while len(self._inflight) < self._depth:
            args = self._next_position()
            self._inflight.append(self._pool.apply_async(_map_one, args) if self._pool
                                  else _Done(_map_one(*args, self._local)))

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._closed:
            raise StopIteration
        while True:
            self._submit()
            s = self._inflight.popleft().get()
            key = tuple((k, np.shape(v)) for k, v in sorted(s.items()))
            if self._sharded and self._pending and key not in self._pending:
                raise ValueError("samples of several shapes (a multi-scale mapper): batches "
                                 "grouped by shape cannot be split by a rank that maps only "
                                 "its own samples; train them data-parallel with a stream "
                                 "a rank (--multihost)")
            batch = self._pending.setdefault(key, [])
            batch.append(s)
            if len(batch) == self.batch_size:
                self._pending[key] = []
                return {k: np.stack([x[k] for x in batch]) for k in batch[0]}

    def close(self):
        self._closed = True
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def make_dataloader(records, mapper, batch_size: int, seed: int = 7, shuffle: bool = True,
                    worker_count: int = 0, shard: tuple | None = None):
    """An endless iterator of stacked numpy batch dicts: worker processes
    for worker_count > 0, else the in-process batch_iterator; with
    `shard=(rank, world)` this rank's slice of each global batch of
    `batch_size` (WorkerLoader)."""
    if shard is not None:
        return WorkerLoader(records, mapper, batch_size, seed=seed, shuffle=shuffle,
                            worker_count=worker_count, shard=shard)
    if not worker_count:
        from quber_tpu_torch.data.mappers import batch_iterator

        return batch_iterator(records, mapper, batch_size, shuffle=shuffle, seed=seed)
    return WorkerLoader(records, mapper, batch_size, seed=seed, shuffle=shuffle,
                        worker_count=worker_count)
