"""Host-side streaming: a background thread decodes frames ahead of the
consumer.

Port of ``segfusion_tpu/data/prefetch.py`` (``collate`` and
``PrefetchLoader``) without its device transfer hook: the port's
``Pipeline.fuse_many`` stacks host frames per chunk and moves each chunk
to the device in one copy per field.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

__all__ = ["PrefetchLoader", "collate"]

_PREFETCH = 4   # batches in flight


def collate(sample: dict) -> dict:
    """Add a leading batch dim of 1 to array fields, wrap numbers in
    arrays and other values (frame ids) in lists."""
    out = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray):
            out[k] = v[None]
        elif isinstance(v, (int, float, np.integer, np.floating)):
            out[k] = np.asarray([v])
        else:
            out[k] = [v]
    return out


class PrefetchLoader:
    """Iterate a dataset (``__len__`` / ``__getitem__`` returning frame
    dicts) in batches, decoded by one background thread when
    ``num_workers`` > 0 (0: in the caller's thread). Batches of one frame
    are collated; larger ones stack array fields along a new axis 0.
    ``shuffle`` permutes the indices with a seeded generator, anew for each
    pass."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self._epoch = 0

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self._epoch).shuffle(idx)
        self._epoch += 1
        return idx

    def _make_batch(self, batch_idx: Sequence[int]) -> dict:
        samples = [self.dataset[int(i)] for i in batch_idx]
        if len(samples) == 1:
            return collate(samples[0])
        return {k: (np.stack([s[k] for s in samples])
                    if isinstance(samples[0][k], np.ndarray)
                    else [s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.num_workers <= 0:
            for b in batches:
                yield self._make_batch(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(b))
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
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
