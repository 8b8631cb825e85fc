"""The port's DataLoader on its fast paths against the JAX package's: a small
time-major corpus written by the port's writer and read by both packages,
native host libraries on in both. The whole-batch native assembly
(`fetch_many_into`), the recycled slot ring and bf16 x slots give the JAX
batches bit for bit over two epochs; num_shards = 2 gives JAX's shards,
which together make the unsharded batch; and the train loop's
`loader_slot_ring` reaches its loader and leaves its batches as they were;
a ring set is refilled only after the copy fence recorded when it was
handed back."""

import dataclasses
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dpot_tpu.data import DataLoader as JaxLoader
from dpot_tpu.data import MixedTemporalDataset as JaxDataset
from dpot_tpu.data import registry as jax_registry
from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset, registry
from dpot_tpu_torch.data import loader as loader_mod
from dpot_tpu_torch.data.generation import write_scatter
from dpot_tpu_torch.native.preprocess import bf16_words
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.utils.config import TrainConfig

NAME = "tloader_tm"
SPEC = dict(name=NAME, train_path=f"{NAME}/train", test_path=f"{NAME}/test", train_size=10,
            test_size=3, scatter_storage=True, t_test=4, t_in=6, t_total=14, in_size=(32, 32),
            n_channels=2, downsample=(1, 1))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    trajs = [rng.standard_normal((32, 32, 14, 2)).astype(np.float32) for _ in range(13)]
    write_scatter(str(root / NAME), trajs[:10], "train", time_major=True)
    write_scatter(str(root / NAME), trajs[10:], "test", time_major=True)
    registry.register_dataset(registry.DatasetSpec(**SPEC))
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(jax_registry.DatasetSpec(
        **{k: v for k, v in SPEC.items() if k in fields}))
    return root


@pytest.fixture(autouse=True)
def env(corpus, monkeypatch):
    monkeypatch.setenv("DPOT_DATA_ROOT", str(corpus))
    monkeypatch.delenv("DPOT_DISABLE_NATIVE", raising=False)
    monkeypatch.setenv("DPOT_NATIVE_THREADS", "2")  # the JAX library's calls
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bits(a):
    """A batch column as comparable bits (bf16 as its uint16 words)."""
    if isinstance(a, torch.Tensor):
        return bf16_words(a).copy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16).copy()
    return a.copy()


def collect(loader, epochs=2):
    """Every batch of `epochs` epochs, copied as it arrives (ring slots are
    refilled afterwards)."""
    out = []
    for ep in range(epochs):
        loader.set_epoch(ep)
        out.extend([tuple(bits(a) for a in b) for b in loader])
    return out


def assert_same(a, b):
    assert len(a) == len(b) > 0
    for pb, jb in zip(a, b):
        for u, v in zip(pb, jb):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def datasets():
    kw = dict(res=32, t_in=6, t_ar=2, train=True)
    return MixedTemporalDataset([NAME], **kw), JaxDataset([NAME], **kw)


# the slots' dtypes (x, y): f32 (the f32 wire), bf16 x (the bf16 compute's
# wire) and both bf16 (wire_dtype bfloat16). The JAX loader cannot fill a
# bf16 x beside an f32 y (its assemble_windows asserts one dtype, ROADMAP
# section 3), so that case holds the port against JAX's f32 batches with x
# rounded by ml_dtypes, which is what the JAX loop then ships
SLOTS = {"f32": (None, None), "bf16_x": (torch.bfloat16, None),
         "bf16": (torch.bfloat16, torch.bfloat16)}
JAX_DT = {None: None, torch.bfloat16: ml_dtypes.bfloat16}


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("slots", sorted(SLOTS))
def test_fast_path_batches_equal_jax_over_two_epochs(prefetch, slots, monkeypatch):
    port, jax = datasets()
    assert port.time_major_batches and jax.time_major_batches
    calls = []
    real = MixedTemporalDataset.fetch_many_into

    def spy(self, *a):
        calls.append(real(self, *a))
        return calls[-1]

    monkeypatch.setattr(MixedTemporalDataset, "fetch_many_into", spy)
    xd, yd = SLOTS[slots]
    kw = dict(batch_size=4, num_workers=2, seed=3, prefetch=prefetch, slot_ring=2)
    got = collect(DataLoader(port, x_dtype=xd, y_dtype=yd, **kw))
    jx, jy = (JAX_DT[xd], JAX_DT[yd]) if slots != "bf16_x" else (None, None)
    want = collect(JaxLoader(jax, x_dtype=jx, y_dtype=jy, **kw))
    if slots == "bf16_x":
        want = [(x.astype(ml_dtypes.bfloat16).view(np.uint16), *rest) for x, *rest in want]
    assert_same(got, want)
    assert len(calls) == len(got) and all(c is not None for c in calls)
    assert got[0][0].dtype == (np.float32 if xd is None else np.uint16)
    assert got[0][1].dtype == (np.float32 if yd is None else np.uint16)


def test_ring_slots_are_reused_and_batches_match_fresh_buffers():
    port, _ = datasets()
    kw = dict(batch_size=4, num_workers=2, seed=5, prefetch=0, x_dtype=torch.bfloat16)
    ring = DataLoader(port, slot_ring=1, **kw)
    fresh = DataLoader(port, **kw)
    assert_same(collect(ring), collect(fresh))
    assert len(ring._ring_sets) == 0 + 1 + 1
    ptrs = {st[0].data_ptr() for st in ring._ring_sets}
    seen = {b[0].data_ptr() for b in ring}
    assert seen <= ptrs


@pytest.mark.parametrize("prefetch", [0, 2])
def test_ring_set_is_refilled_only_after_its_copy_fence(prefetch, monkeypatch):
    """A pinned ring's set goes back to the ring with a fence recorded on
    the consumer's stream, and is refilled only after that fence completes.
    Here the copies are threads that read the batch 20 ms after the
    consumer got it (an asynchronous copy to the card still in flight when
    the consumer pulls the next batches), and a fence waits for the copies
    started before it: every copy still reads its own batch, the first of
    each epoch included (in a ring slot, the corpus being time-major)."""
    copies = []

    def fence():
        started = list(copies)

        class Fence:
            def synchronize(self):
                for t, _ in started:
                    t.join()
        return Fence()

    slots = DataLoader._slots
    monkeypatch.setattr(loader_mod, "_copy_fence", fence)
    monkeypatch.setattr(DataLoader, "_slots",
                        lambda self, n, shapes, pinned: slots(self, n, shapes, False))
    port, _ = datasets()
    assert port.fast_item_shapes is not None
    kw = dict(batch_size=2, num_workers=2, seed=6, prefetch=prefetch, x_dtype=torch.bfloat16)
    ring = DataLoader(port, slot_ring=1, **kw)
    ring.pin_memory = True  # the fenced ring of a CUDA host, its slots unpinned here
    for ep in range(2):
        ring.set_epoch(ep)
        for x, y, _, _ in ring:
            out = {}

            def copy(x=x, y=y, out=out):
                time.sleep(0.02)
                out["xy"] = (bits(x), bits(y))

            t = threading.Thread(target=copy)
            t.start()
            copies.append((t, out))
    for t, _ in copies:
        t.join()
    want = collect(DataLoader(port, **kw))
    assert len(copies) == len(want) == 10
    for (_, out), w in zip(copies, want):
        for u, v in zip(out["xy"], w[:2]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("x_bf16", [False, True])
def test_two_shards_equal_jax_and_make_the_whole_batch(x_bf16):
    port, jax = datasets()
    kw = dict(batch_size=4, num_workers=2, seed=2, prefetch=2, slot_ring=2)
    pdt, jdt = (torch.bfloat16, ml_dtypes.bfloat16) if x_bf16 else (None, None)
    whole = collect(DataLoader(port, x_dtype=pdt, y_dtype=pdt, **kw))
    shards = []
    for i in range(2):
        got = collect(DataLoader(port, num_shards=2, shard_index=i, x_dtype=pdt, y_dtype=pdt,
                                 **kw))
        want = collect(JaxLoader(jax, num_shards=2, shard_index=i, x_dtype=jdt, y_dtype=jdt,
                                 **kw))
        assert_same(got, want)
        shards.append(got)
    assert 2 * len(DataLoader(port, num_shards=2, **kw)) == len(shards[0]) == len(whole)
    joined = [tuple(np.concatenate([a[k], b[k]]) for k in range(4))
              for a, b in zip(*shards)]
    assert_same(joined, whole)


def test_shards_must_divide_the_batch():
    port, _ = datasets()
    with pytest.raises(ValueError, match="must divide"):
        DataLoader(port, batch_size=5, num_shards=2)


def tiny_cfg(**kw):
    return TrainConfig(model="DPOT", train_paths=[NAME], test_paths=[NAME], res=32,
                       patch_size=8, width=16, n_layers=1, n_blocks=2, modes=2, T_in=6,
                       T_ar=2, batch_size=4, epochs=2, num_workers=2, lr=1e-3,
                       warmup_epochs=1, noise_scale=0.01, **kw)


@pytest.mark.parametrize("ring,want", [(3, 3), (-1, 2), (0, 0)])
def test_loader_slot_ring_reaches_the_loader(ring, want):
    cfg = tiny_cfg(loader_slot_ring=ring)
    *_, train_dl, _, _ = loop.build_everything(cfg, "cpu")
    assert train_dl.slot_ring == want
    assert train_dl.pin_memory == (want > 0 and torch.cuda.is_available())


def test_finetune3d_passes_loader_slot_ring(monkeypatch):
    import dpot_tpu_torch.data as data
    from dpot_tpu_torch.cli.finetune3d import main

    kw = dict(name="tloader_3d", train_path="", test_path="", train_size=2, test_size=1,
              scatter_storage=False, t_test=2, t_in=10, t_total=6, in_size=(8, 8, 8),
              n_channels=2, downsample=(1, 1, 1), synthetic=True)
    registry.register_dataset(registry.DatasetSpec(**kw))
    seen = []

    class Recording(data.DataLoader):
        def __init__(self, *a, **k):
            seen.append(k.get("slot_ring", 0))
            super().__init__(*a, **k)

    monkeypatch.setattr(data, "DataLoader", Recording)
    main(["--train_paths", "tloader_3d", "--res", "8", "--patch_size", "4", "--width", "16",
          "--n_layers", "1", "--n_blocks", "2", "--modes", "2", "--T_in", "3", "--epochs", "1",
          "--batch_size", "2", "--num_workers", "2", "--loader_slot_ring", "3", "--device", "cpu"])
    assert seen[0] == 3


@pytest.mark.parametrize("prefetch", [-1, 0])
def test_train_loop_batches_with_the_ring_equal_those_without(prefetch, monkeypatch):
    """Two epochs of the loop (bf16 compute, so x ships as bf16 from the
    loader's slots) at loader_slot_ring 0 and 3: every batch a step sees
    and every loss bit for bit."""
    real = loop.make_train_step

    def run(ring):
        seen = []

        def spying(**kw):
            step = real(**kw)

            def wrapped(state, batch):
                seen.append({k: v.clone() for k, v in batch.items()})
                return step(state, batch)
            return wrapped

        monkeypatch.setattr(loop, "make_train_step", spying)
        out = loop.train(tiny_cfg(loader_slot_ring=ring, loader_prefetch=prefetch,
                                  dtype="bfloat16", seed=4), device="cpu")
        return seen, out

    (a, out_a), (b, out_b) = run(0), run(3)
    assert len(a) == len(b) == 6
    assert a[-1]["x"].dtype == torch.bfloat16 and a[-1]["y"].dtype == torch.float32
    for u, v in zip(a, b):
        assert u.keys() == v.keys()
        for k in u:
            assert torch.equal(u[k], v[k]), k
    assert out_a["train_l2_step"] == out_b["train_l2_step"]
    assert out_a["test_l2_fulls"] == out_b["test_l2_fulls"]
