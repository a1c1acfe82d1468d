"""Host-side input pipeline: batching, shuffling, background prefetch
(counterpart of `diffroll_tpu/data/pipeline.py`: `collate` and `DataLoader`).

Batches are assembled on the host by a background thread pool as numpy
arrays; `to_device` carries one to the model's device through pinned memory
with a non-blocking copy. The JAX package's packed-transfer helpers
(`pack_batch`, `unpack_batch`, `device_prefetch`) are not ported.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def collate(items: Sequence[Any]) -> Any:
    """Stack dict-of-arrays items (tuples/lists are collated per element)."""
    first = items[0]
    if isinstance(first, dict):
        out = {}
        for k, v in first.items():
            if isinstance(v, np.ndarray) or np.isscalar(v):
                out[k] = np.stack([np.asarray(it[k]) for it in items])
            else:
                out[k] = [it[k] for it in items]  # e.g. file names
        return out
    if isinstance(first, (tuple, list)):
        return type(first)(
            collate([it[i] for it in items]) for i in range(len(first))
        )
    return np.stack([np.asarray(it) for it in items])


def to_device(batch: Any, device) -> Any:
    """numpy batch (a dict, or a tuple of dicts for the dual recipe) ->
    tensors on `device`. For a CUDA device the host tensors are pinned and
    copied with `non_blocking=True`, so the copy overlaps the step that is
    still running on the stream. Leaves that are no numeric arrays (file
    names) pass through."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.dtype.kind not in "biuf":
            out[k] = v
            continue
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
    return out


def _take_rows(batch: Any, n: int) -> Any:
    """The first n rows of every leaf of a collated batch."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_take_rows(b, n) for b in batch)
    return {k: v[:n] for k, v in batch.items()}


def _tag_rows(batch: Any, rows: int) -> Any:
    """Record the global batch's row count in each dict of a stripe."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tag_rows(b, rows) for b in batch)
    return {**batch, "global_rows": rows}


class DataLoader:
    """Minimal epoch iterator: shuffle, batch, parallel fetch, prefetch.

    With `process_count` > 1 (the data axis, parallel/mesh.py) every process
    walks the same global batches of `batch_size` and reads only its rows
    `process_index::process_count` of each, and each batch dict carries the
    global batch's row count as the int `global_rows`. So every process
    takes the same number of steps, and the union of the stripes of batch k
    is the single-process batch k. (The JAX loader stripes the index and
    batches each stripe, for a per-host batch; the stripes of a full global
    batch hold the same clips.) A stripe of a short last batch may be empty:
    its arrays then have zero rows.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = 0
        self._seed = seed
        self._executor: Optional[cf.ThreadPoolExecutor] = None

    def __del__(self):
        ex = getattr(self, "_executor", None)
        if ex is not None:
            try:
                ex.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass  # interpreter teardown

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices_for_epoch(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self._seed + epoch)
            rng.shuffle(idx)
        return idx

    def _pool(self) -> cf.ThreadPoolExecutor:
        # ONE persistent pool per loader, with consumer-pulled futures: a
        # dedicated producer thread feeding a queue spends its time in GIL
        # handoff between producer and consumer.
        if self._executor is None:
            self._executor = cf.ThreadPoolExecutor(self.num_workers)
        return self._executor

    def _make_batch(self, b: np.ndarray, epoch: int) -> Any:
        # runs inside a worker: fetch + collate so the consumer thread
        # only unblocks on a finished batch. Datasets exposing
        # `getitem_at(idx, epoch)` get the epoch explicitly, making random
        # train windows a pure function of (seed, clip, epoch) — no shared
        # draw counter, so even concurrent iterators stay reproducible.
        if self.process_count == 1:
            return self._collate(b, epoch)
        mine = b[self.process_index::self.process_count]
        out = self._collate(mine if len(mine) else b[:1], epoch)
        if not len(mine):
            out = _take_rows(out, 0)
        return _tag_rows(out, len(b))

    def _collate(self, b: np.ndarray, epoch: int) -> Any:
        if hasattr(self.dataset, "getitem_at"):
            return collate([self.dataset.getitem_at(j, epoch) for j in b])
        return collate([self.dataset[j] for j in b])

    def __iter__(self) -> Iterator[Any]:
        epoch = self._epoch
        idx = self._indices_for_epoch(epoch)
        self._epoch += 1
        batches: List[np.ndarray] = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        pool = self._pool()
        # one task per batch; parallelism comes from `prefetch` batches in
        # flight across the workers (within-batch fan-out measured slower:
        # 16 sub-millisecond tasks per batch are pure scheduling overhead).
        # prefetch bounds host memory: at most prefetch collated batches
        # exist at once (num_workers only caps thread concurrency).
        depth = max(self.prefetch, 1)
        pending: "collections.deque" = collections.deque()
        it = iter(batches)
        try:
            for b in itertools.islice(it, depth):
                pending.append(pool.submit(self._make_batch, b, epoch))
            while pending:
                fut = pending.popleft()
                nb = next(it, None)
                if nb is not None:
                    pending.append(pool.submit(self._make_batch, nb, epoch))
                yield fut.result()
        finally:
            # abandoned mid-epoch (break / exception / GeneratorExit):
            # cancel queued work and WAIT for running tasks, so no stale
            # dataset fetch can race a later epoch's draw-count ordering
            for f in pending:
                if not f.cancel():
                    try:
                        f.exception()
                    except BaseException:
                        pass
