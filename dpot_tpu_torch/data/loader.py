"""Threaded batch loader (the port's copy of `DataLoader` in
dpot_tpu/data/loader.py).

HDF5/numpy reads and the native preprocessing release the GIL, so a thread
pool fills each batch and a producer thread keeps `prefetch` batches ready
ahead of the train loop (prefetch = 0: inline, in the consumer's thread).
The shuffle order is a permutation seeded by (seed, epoch), and each item's
window draw comes from a stateless 64-bit word of (seed, epoch, global
index), so a batch is the same bit for bit as the JAX package's for the same
seed and epoch, and `set_epoch` replays an epoch exactly (resume).

Batches are (x, y, msk, cls): numpy arrays, except that a bfloat16 column
(x_dtype / y_dtype = torch.bfloat16) is a torch.bfloat16 tensor, since
numpy has no bfloat16. Once the loader knows the slot shapes (declared by
the dataset, or learnt from the first batch) it writes every item straight
into its batch slot (`fetch_into`), or a whole time-major batch in one
native call (`fetch_many_into`), converting to the slot's dtype in that
pass. With `slot_ring` the slots are allocated once, as pinned host memory
where CUDA is available, and recycled (the lag-K contract in __init__).

With num_shards > 1 every shard walks the same global batch order and
loads its contiguous slice of each batch. A batch that does not split
evenly (an epoch's tail) goes whole to every shard, which computes it
whole, so that the ranks of a multi-process run (parallel/) take the
samples of one process; the JAX loader skips such a batch, and the JAX
loop's multi-host fallback gathers the host slices of one.
"""

from __future__ import annotations

import inspect
import queue
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from dpot_tpu_torch.native import preprocess as native

# sys.setswitchinterval while a threaded iterator is live (restored after),
# so that the producer-consumer handoff does not wait out the interpreter's
# default 5 ms
_GIL_INTERVAL = 1e-4

_malloc_tuned = False


def _tune_malloc() -> None:
    """Raise glibc's mmap and trim thresholds once per process, so that
    batch buffers (tens of MB each) come back from the arena instead of
    fresh mmap regions that fault in every page on every batch. A no-op
    off glibc."""
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 256 * 1024 * 1024)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 256 * 1024 * 1024)  # M_TRIM_THRESHOLD
    except OSError:
        pass


_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _window_words(seed: int, epoch: int, base: int, n: int) -> np.ndarray:
    """Per-item 64-bit random words: splitmix64 of the global item index
    mixed with the (seed, epoch) stream id. Keyed by the global index, so
    shards draw the same words for the same items."""
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


def _copy_fence():
    """A CUDA event recorded on the current stream: it completes once every
    copy the consumer has queued so far, those out of a ring slot included."""
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _slot_dtype(d) -> torch.dtype:
    """A slot's dtype: float32 (None, numpy's or torch's) or torch.bfloat16."""
    if d is None or d == torch.float32:
        return torch.float32
    if d == torch.bfloat16:
        return torch.bfloat16
    if not isinstance(d, torch.dtype) and np.dtype(d) == np.float32:
        return torch.float32
    raise ValueError(f"slot dtype {d!r}: float32 or torch.bfloat16")


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
        num_shards: int = 1,
        shard_index: int = 0,
        x_dtype=None,
        y_dtype=None,
        slot_ring: int = 0,
    ):
        """batch_size is the global batch size; with num_shards > 1 this
        loader yields shard `shard_index` of each global batch.

        x_dtype / y_dtype: the slots' dtype (float32 or torch.bfloat16, the
        train wire format). The conversion rides the one assembly copy;
        only batches that go through the slots convert (the first batch
        teaches the slot shapes unless the dataset declares them).

        slot_ring: recycled batch buffers. With slot_ring = K the loader
        cycles through prefetch + 1 + K slot sets allocated once (pinned
        host memory where CUDA is available); a yielded batch's buffers are
        reused once K further batches have been yielded. So the consumer's
        host code must be done with batch i by the time it pulls batch
        i + K. An asynchronous copy to the card that reads the batch may
        still be running then: the pull records a CUDA event on the
        consumer's current stream as the set goes back to the ring, and the
        set is refilled only after that event. Consumers that hold batches
        longer leave this at 0 (fresh buffers, the default)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self.x_dtype = x_dtype
        self.y_dtype = y_dtype
        self.slot_ring = int(slot_ring)
        # pinned slots cross to the card asynchronously; their reuse waits
        # on a copy fence
        self.pin_memory = self.slot_ring > 0 and torch.cuda.is_available()
        self._ring_sets: list = []  # the recycled slot sets, built once
        self._epoch = 0
        _tune_malloc()
        if self.num_shards > 1 and batch_size % self.num_shards != 0:
            raise ValueError(
                f"num_shards {self.num_shards} must divide the global batch_size "
                f"{batch_size} (every shard loads batch_size/num_shards items)"
            )

    def set_epoch(self, epoch: int):
        """The next __iter__ replays the permutation and draws of `epoch`."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        full, rem = divmod(len(self.dataset), self.batch_size)
        if self.drop_last:
            return full
        return full + (1 if rem else 0)

    def _batches(self) -> list[np.ndarray]:
        n = len(self.dataset)
        # tuple seeding: seed + epoch would make adjacent seeds replay each
        # other's permutations shifted by one epoch
        rng = np.random.default_rng((self.seed, self._epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:limit]
        return [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def _slots(self, n: int, shapes, pinned: bool) -> tuple:
        """One slot set: (x tensor, x numpy view, y tensor, y numpy view,
        msk or None); a bf16 slot's numpy view holds its uint16 words."""
        out = []
        for shape, dtype in ((shapes[0], _slot_dtype(self.x_dtype)),
                             (shapes[1], _slot_dtype(self.y_dtype))):
            t = torch.empty((n, *shape), dtype=dtype, pin_memory=pinned)
            out += [t, native.bf16_words(t) if dtype == torch.bfloat16 else t.numpy()]
        return (*out, None if shapes[2] is None else np.empty((n, *shapes[2]), np.float32))

    def __iter__(self) -> Iterator[tuple]:
        pairs, base = [], 0
        for b in self._batches():
            pairs.append((base, b))
            base += len(b)
        if self.num_shards > 1:
            sharded = []
            for gbase, b in pairs:
                per, rem = divmod(len(b), self.num_shards)
                if rem:  # every shard takes the whole batch
                    sharded.append((gbase, b))
                    continue
                lo = self.shard_index * per
                sharded.append((gbase + lo, b[lo: lo + per]))
            pairs = sharded
        rng_key = (self.seed, self._epoch)
        self._epoch += 1
        ds = self.dataset
        try:
            supports_rng = "rng" in inspect.signature(ds.__getitem__).parameters
        except (TypeError, ValueError):
            supports_rng = False
        use_into = callable(getattr(ds, "fetch_into", None))
        declared = getattr(ds, "fast_item_shapes", None)
        # the slot shapes: declared by a dataset that ships time-major
        # batches, else learnt from the first batch
        slot_shapes: list = list(declared) if (use_into and declared) else []
        # all-ones train masks come from one shared buffer
        elide_msk = bool(getattr(ds, "train_masks_are_ones", False))
        shared_msk: list = []
        many = getattr(ds, "fetch_many_into", None)
        stop = threading.Event()
        # (slot set, copy fence or None): a set goes back to the ring with
        # the fence its refill waits for
        ring_free: queue.Queue = queue.Queue()

        def release(slotset):
            ring_free.put((slotset, _copy_fence() if self.pin_memory else None))

        if self.slot_ring > 0:
            # every set is free at the start of an epoch once the copies the
            # consumer queued before it are done: the end-of-epoch join below
            # waits out a producer still writing into one
            for st in self._ring_sets:
                release(st)

        def take_ring_set():
            if not self._ring_sets:
                shapes = (*slot_shapes[:2], None if elide_msk else slot_shapes[2])
                for _ in range(self.prefetch + 1 + self.slot_ring):
                    self._ring_sets.append(self._slots(self.batch_size, shapes,
                                                       self.pin_memory))
                for st in self._ring_sets:
                    ring_free.put((st, None))
            while not stop.is_set():
                try:
                    st, fence = ring_free.get(timeout=0.2)
                except queue.Empty:
                    continue
                if fence is not None:
                    fence.synchronize()
                return st
            return None

        def fetch_batch_into(pool, ids, gbase):
            n = len(ids)
            slotset = None
            if self.slot_ring > 0:
                slotset = take_ring_set()
                if slotset is None:  # the consumer left the epoch
                    return None, None
                xt, xs, yt, ys, msk_slot = slotset
                xt, xs, yt, ys = xt[:n], xs[:n], yt[:n], ys[:n]
            else:
                xt, xs, yt, ys, msk_slot = self._slots(
                    n, (*slot_shapes[:2], None if elide_msk else slot_shapes[2]), False)
            if elide_msk:
                if not shared_msk:
                    shared_msk.append(np.ones((self.batch_size, *slot_shapes[2]), np.float32))
                msk = shared_msk[0][:n]
            else:
                msk = msk_slot[:n]
            cls = np.empty((n,), np.int32)
            words = _window_words(*rng_key, gbase, n)
            got = None if many is None else many(ids, words, xs, ys,
                                                 None if elide_msk else msk)
            if got is not None:
                cls[:] = got
            elif self.num_workers == 1:
                for j in range(n):
                    cls[j] = ds.fetch_into(int(ids[j]), xs[j], ys[j],
                                           None if elide_msk else msk[j], words[j])
            else:
                def one(j):
                    cls[j] = ds.fetch_into(int(ids[j]), xs[j], ys[j],
                                           None if elide_msk else msk[j], words[j])

                list(pool.map(one, range(n)))
            x = xt if xt.dtype == torch.bfloat16 else xs
            y = yt if yt.dtype == torch.bfloat16 else ys
            return (x, y, msk, cls), slotset

        def fetch_item(k, i):
            if supports_rng:
                return ds.__getitem__(int(i), rng=_window_words(*rng_key, k, 1)[0])
            return ds[int(i)]

        def fetch_batch(pool, ids, gbase):
            if slot_shapes:
                return fetch_batch_into(pool, ids, gbase)
            items = list(pool.map(fetch_item, range(gbase, gbase + len(ids)), ids))
            out = tuple(np.stack(c) if np.ndim(c[0]) > 0 else np.asarray(c)
                        for c in zip(*items))
            if use_into and len(out) == 4 and all(
                    isinstance(a, np.ndarray) and a.dtype == np.float32 for a in out[:3]):
                slot_shapes.extend(a.shape[1:] for a in out[:3])
            return out, None

        if self.prefetch == 0:
            # inline: batch i + 1 is assembled while the device runs step i
            held_i: deque = deque()
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for gbase, b in pairs:
                        batch, slotset = fetch_batch(pool, b, gbase)
                        if batch is None:
                            return
                        if slotset is not None:
                            held_i.append(slotset)
                            if len(held_i) > self.slot_ring:
                                release(held_i.popleft())
                        yield batch
            finally:
                stop.set()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

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
                        if stop.is_set():
                            return
                        batch, slotset = fetch_batch(pool, b, gbase)
                        if batch is None or not put((batch, slotset)):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        old_interval = sys.getswitchinterval()
        sys.setswitchinterval(_GIL_INTERVAL)
        held: deque = deque()  # yielded slot sets not yet free
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, slotset = item
                if slotset is not None:
                    # the set yielded slot_ring batches ago is free again
                    held.append(slotset)
                    if len(held) > self.slot_ring:
                        release(held.popleft())
                yield batch
        finally:
            stop.set()
            t.join(timeout=10.0)
            sys.setswitchinterval(old_interval)
