"""Batch loader: threaded prefetch + per-process sharding.

The port's copy of ``mmvid_tpu/data/loader.py``, the replacement for the
reference's DataLoader(DistributedSampler, workers) (train.py:224-234):
the loader shards the *index space* per process
(process_index/process_count) and feeds numpy batches.  Decoding happens
in a thread pool (the frame core of ``data/png.py`` and zlib release the
GIL) with a bounded prefetch queue.  Two additions: ``infinite_batches``
can start ``start`` batches in, so a resumed run reads the batches an
uninterrupted one would have read; and ``shard='block'``, the training
driver's over data-parallel ranks, gives each process its block of every
global batch (``process_count * batch_size`` indices) where JAX's
strided shard (``'stride'``, the default) gives it every
``process_count``-th index, so that the ranks' batches, laid end to end
in rank order, are the batches one process reads at the global batch.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def collate(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack dict samples; string fields become lists."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class Subset:
    """Index-remapped dataset view (torch.utils.data.Subset equivalent,
    used by --limit_train_batches, reference train.py:217-219)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, shard: str = 'stride'):
        if shard not in ('stride', 'block'):
            raise ValueError(f'shard {shard!r}: expected stride or block')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.shard = shard
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch (reference sampler.set_epoch,
        utils/utils.py:97-104)."""
        self.epoch = epoch

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        idx = list(range(n))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.shard == 'block':
            return idx
        # per-host shard (DistributedSampler equivalent); pad with
        # wrap-around so every host sees the SAME number of indices —
        # unequal shards would desync the hosts' collective step loops
        # (torch DistributedSampler does the same total_size padding)
        if self.process_count > 1:
            total = -(-n // self.process_count) * self.process_count
            idx = idx + idx[:total - n]
        return idx[self.process_index::self.process_count]

    def __len__(self):
        return len(self._batches(self._indices()))

    def _batches(self, idx: List[int]) -> List[List[int]]:
        """This process's batches of the epoch's indices ``idx`` (with
        ``'stride'`` already its shard): its slice of each global batch
        of ``ranks * batch_size`` indices."""
        ranks = self.process_count if self.shard == 'block' else 1
        g = self.batch_size * ranks
        nb = len(idx) // g if self.drop_last else -(-len(idx) // g)
        if ranks > 1 and len(idx) < nb * g:
            # the last global batch padded by wrap-around, so every
            # process reads as many batches
            idx = (idx * -(-nb * g // len(idx)))[:nb * g]
        lo = self.process_index * self.batch_size if ranks > 1 else 0
        return [idx[i * g + lo:i * g + lo + self.batch_size]
                for i in range(nb)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, skip: int) -> Iterator[Dict[str, np.ndarray]]:
        """This epoch's batches after the first ``skip``, which are not
        read."""
        batches = self._batches(self._indices())[skip:]
        pool = ThreadPoolExecutor(self.num_workers)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early never drains the queue: give up
            # then, so this thread ends instead of waiting on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    futures = [pool.submit(self.dataset.__getitem__, i)
                               for i in b]
                    if not put(collate([f.result() for f in futures])):
                        return
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def infinite_batches(loader: DataLoader, start: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator with epoch-stepped reshuffling
    (reference sample_data, utils/utils.py:97-104), from the ``start``-th
    batch of that sequence on (the earlier ones are not read)."""
    n = len(loader)
    if n == 0:
        raise ValueError('the loader has no batch: the dataset holds fewer '
                         'samples than one batch')
    epoch, skip = divmod(start, n)
    while True:
        loader.set_epoch(epoch)
        yield from loader.iter_from(skip)
        epoch, skip = epoch + 1, 0
