"""Threaded batch loader (the port's copy of `DataLoader` in
dpot_tpu/data/loader.py, single process).

HDF5/numpy reads release the GIL, so a thread pool fills each batch and a
producer thread keeps `prefetch` batches ready ahead of the train loop. The
shuffle order is a permutation seeded by (seed, epoch), and each item's
window draw comes from a stateless 64-bit word of (seed, epoch, global
index), so a batch is the same bit for bit as the JAX package's for the same
seed and epoch, and `set_epoch` replays an epoch exactly (resume). Batches
are numpy arrays (x, y, msk, cls); the train loop copies them to the device
through pinned memory. Sharding over hosts, recycled slot buffers and the
native whole-batch assembly of the JAX loader wait (ROADMAP, 'Modules to
port', items 7 and 12).
"""

from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _window_words(seed: int, epoch: int, base: int, n: int) -> np.ndarray:
    """Per-item 64-bit random words: splitmix64 of the global item index
    mixed with the (seed, epoch) stream id."""
    x = np.arange(base, base + n, dtype=np.uint64)
    x = (x + np.uint64(1)) * _SM_GAMMA + np.uint64(
        (int(seed) & 0xFFFFFFFF) << 20 | ((int(epoch) + 1) & 0xFFFFF)
    )
    z = x.copy()
    z ^= z >> np.uint64(30)
    z *= _SM_M1
    z ^= z >> np.uint64(27)
    z *= _SM_M2
    z ^= z >> np.uint64(31)
    return z


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 8,
    ):
        """prefetch = 0 assembles each batch inline, in the consumer's
        thread; otherwise a producer thread keeps up to `prefetch` batches
        queued."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """The next __iter__ replays the permutation and draws of `epoch`."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        full, rem = divmod(len(self.dataset), self.batch_size)
        return full if self.drop_last else full + (1 if rem else 0)

    def _batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        # tuple seeding: seed + epoch would make adjacent seeds replay each
        # other's permutations shifted by one epoch
        rng = np.random.default_rng((self.seed, self._epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:limit]
        return [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def __iter__(self) -> Iterator[tuple]:
        pairs, base = [], 0
        for b in self._batches():
            pairs.append((base, b))
            base += len(b)
        rng_key = (self.seed, self._epoch)
        self._epoch += 1
        ds = self.dataset
        try:
            supports_rng = "rng" in inspect.signature(ds.__getitem__).parameters
        except (TypeError, ValueError):
            supports_rng = False
        # a dataset that ships time-major batches names its slot shapes and
        # fills them item by item (grid_dataset.fetch_into)
        slot_shapes = getattr(ds, "fast_item_shapes", None)
        elide_msk = bool(getattr(ds, "train_masks_are_ones", False))

        def fetch_batch(pool, ids, gbase):
            n = len(ids)
            words = _window_words(*rng_key, gbase, n)
            if slot_shapes is not None:
                x = np.empty((n, *slot_shapes[0]), np.float32)
                y = np.empty((n, *slot_shapes[1]), np.float32)
                msk = np.ones((n, *slot_shapes[2]), np.float32)
                cls = np.empty((n,), np.int32)

                def one(j):
                    cls[j] = ds.fetch_into(int(ids[j]), x[j], y[j],
                                           None if elide_msk else msk[j], words[j])

                list(pool.map(one, range(n)))
                return x, y, msk, cls

            def item(j):
                if supports_rng:
                    return ds.__getitem__(int(ids[j]), rng=words[j])
                return ds[int(ids[j])]

            cols = list(zip(*pool.map(item, range(n))))
            return tuple(np.stack(c) if np.ndim(c[0]) > 0 else np.asarray(c) for c in cols)

        if self.prefetch == 0:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for gbase, b in pairs:
                    yield fetch_batch(pool, b, gbase)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early must not strand the producer in put()
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for gbase, b in pairs:
                        if stop.is_set() or not put(fetch_batch(pool, b, gbase)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
