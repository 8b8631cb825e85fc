"""The port's corpus writers and converters (dpot_tpu_torch/data/generation.py,
converters.py) against the JAX package's: files that either package writes
read the same through the other's readers, and every converter writes the
same arrays from the same tiny fabricated raw corpus."""

import json
import os
from pathlib import Path

import h5py
import numpy as np
import pytest

import dpot_tpu.data.converters as jconv
import dpot_tpu.data.generation as jgen
from dpot_tpu.data import raw_hdf5 as jraw
from dpot_tpu.data import registry as jax_registry
import dpot_tpu_torch.data.converters as tconv
import dpot_tpu_torch.data.generation as tgen
from dpot_tpu_torch.data import raw_hdf5 as traw
from dpot_tpu_torch.data import registry


def trajs(n, shape=(8, 6, 5, 2), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def read_tree(root) -> dict:
    """{relative path: {dataset: (array, attrs)}} of every HDF5 file under root."""
    out = {}
    for p in sorted(Path(root).rglob("*")):
        if p.is_file():
            with h5py.File(p, "r") as f:
                out[str(p.relative_to(root))] = {
                    k: (f[k][()], dict(f[k].attrs)) for k in f.keys()}
    return out


def assert_trees_equal(a, b):
    ta, tb = read_tree(a), read_tree(b)
    assert ta.keys() == tb.keys() and ta
    for name in ta:
        assert ta[name].keys() == tb[name].keys()
        for k in ta[name]:
            (u, ua), (v, va) = ta[name][k], tb[name][k]
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
            assert ua == va


WRITERS = [(tgen, jraw, "port writes, JAX reads"), (jgen, traw, "JAX writes, port reads")]


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("writer,reader,_", WRITERS, ids=[w[2] for w in WRITERS])
def test_scatter_files_cross_read(tmp_path, writer, reader, _, time_major):
    data = trajs(3)
    assert writer.write_scatter(str(tmp_path), data, "train", time_major=time_major) == 3
    r = reader.RawScatterReader(str(tmp_path / "train"), n_spatial=2)
    assert r.time_major == time_major
    for i, t in enumerate(data):
        want = np.moveaxis(t, -2, 0) if time_major else t
        np.testing.assert_array_equal(r.read(i), want)
        np.testing.assert_array_equal(r.read(i, tsel=slice(1, 4)),
                                      want[1:4] if time_major else want[:, :, 1:4])


@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("writer,reader,_", WRITERS, ids=[w[2] for w in WRITERS])
def test_single_files_cross_read(tmp_path, writer, reader, _, time_major):
    data = np.stack(trajs(4, seed=1))
    path = str(tmp_path / "d.hdf5")
    writer.write_single(path, data, time_major=time_major)
    r = reader.RawSingleReader(path, n_spatial=2)
    assert r.time_major == time_major
    for i in range(4):
        want = np.moveaxis(data[i], -2, 0) if time_major else data[i]
        np.testing.assert_array_equal(r.read(i), want)


@pytest.mark.parametrize("time_major", [False, True])
def test_writers_write_the_same_files(tmp_path, time_major):
    for mod, d in ((tgen, "port"), (jgen, "jax")):
        mod.write_scatter(str(tmp_path / d / "sc"), trajs(2), "test", time_major=time_major)
        mod.write_single(str(tmp_path / d / "single.hdf5"), np.stack(trajs(2, seed=3)),
                         time_major=time_major)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_time_major_writer_refuses_channel_less_trajectories(tmp_path):
    with pytest.raises(AssertionError, match="channeled"):
        tgen.write_scatter(str(tmp_path), [np.zeros((4, 5), np.float32)], time_major=True)


@pytest.mark.parametrize("time_major", [False, True])
def test_generate_synthetic_corpus_matches_jax(tmp_path, time_major):
    kw = dict(n_train=3, n_test=2, in_size=(16, 12), t_total=9, n_channels=2,
              time_major=time_major)
    name = f"tgen_synth_{int(time_major)}"
    tgen.generate_synthetic_corpus(str(tmp_path / "port"), name=name, **kw)
    jgen.generate_synthetic_corpus(str(tmp_path / "jax"), name=name, **kw)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    a, b = registry.get_spec(name), jax_registry.get_spec(name)
    assert not a.synthetic and (a.train_size, a.t_test, a.in_size, a.n_channels) == \
        (b.train_size, b.t_test, b.in_size, b.n_channels)


def test_split_train_test_matches_jax():
    for n, frac in ((10, 0.1), (7, 0.3), (1, 0.5)):
        for u, v in zip(tgen.split_train_test(n, frac), jgen.split_train_test(n, frac)):
            np.testing.assert_array_equal(u, v)


def fake_pdebench(path: Path, kind: str, n=5, T=4, X=6, Y=6):
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        if kind == "ns2d":
            for k in ("Vx", "Vy", "density", "pressure"):
                f.create_dataset(k, data=rng.standard_normal((n, T, X, Y)).astype(np.float32))
        elif kind == "ns3d":
            for k in ("Vx", "Vy", "Vz", "pressure", "density"):
                f.create_dataset(k, data=rng.standard_normal((n, T, 4, 4, 4)).astype(np.float32))
        else:  # swe / dr: one group per sample
            for i in range(n):
                f.create_dataset(f"{i:04d}/data",
                                 data=rng.standard_normal((T, X, Y, 1)).astype(np.float32))


@pytest.mark.parametrize("kind,time_major,n_train", [("ns2d", False, None), ("ns2d", True, 3),
                                                      ("swe", False, None), ("dr", True, None),
                                                      ("ns3d", False, 4)])
def test_convert_pdebench_matches_jax(tmp_path, kind, time_major, n_train):
    src = tmp_path / "raw.h5"
    fake_pdebench(src, kind)
    kw = dict(kind=kind, n_train=n_train, time_major=time_major)
    assert tgen.convert_pdebench(str(src), str(tmp_path / "port"), **kw) == \
        jgen.convert_pdebench(str(src), str(tmp_path / "jax"), **kw)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_fno_mat_converter_matches_jax(tmp_path):
    import scipy.io as sio

    u = np.random.default_rng(3).standard_normal((3, 8, 8, 5))
    for split in ("train", "test"):
        sio.savemat(tmp_path / f"{split}.mat", {"u": u})
    np.testing.assert_array_equal(tgen.load_fno_mat(str(tmp_path / "train.mat")),
                                  jgen.load_fno_mat(str(tmp_path / "train.mat")))
    for mod, d in ((tgen, "port"), (jgen, "jax")):
        mod.convert_fno_mat(str(tmp_path / "train.mat"), str(tmp_path / "test.mat"),
                            str(tmp_path / d / "tr.hdf5"), str(tmp_path / d / "te.hdf5"))
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


CASE_JSON = {
    "cavity": dict(vel_top=12.0, density=4.0, viscosity=0.01, height=1.0, width=1.0),
    "tube": dict(vel_in=8.0, density=3.0, viscosity=0.02, height=1.0, width=2.0),
    "cylinder": dict(vel_in=6.0, density=2.0, viscosity=0.03, radius=0.2, x_min=-0.5,
                     x_max=1.5, y_min=-0.5, y_max=1.5),
    "dam": dict(velocity=0.05, density=1.5, viscosity=0.04, barrier_width=0.2,
                barrier_height=0.3, dx=0.1, dy=0.1, height=1.0, width=1.0),
}


def fake_cfdbench(root: Path, problems, n_cases=3, T=6, h=6, w=7):
    rng = np.random.default_rng(4)
    for problem in problems:
        for subset in ("prop", "bc", "geo"):
            for i in range(n_cases):
                d = root / problem / subset / f"case{i}"
                d.mkdir(parents=True)
                np.save(d / "u.npy", rng.standard_normal((T, h, w)))
                np.save(d / "v.npy", rng.standard_normal((T, h, w)))
                (d / "case.json").write_text(json.dumps(CASE_JSON[problem]))


@pytest.mark.parametrize("problem", sorted(CASE_JSON))
def test_cfdbench_case_loader_matches_jax(tmp_path, problem):
    fake_cfdbench(tmp_path, [problem], n_cases=1)
    case = str(tmp_path / problem / "prop" / "case0")
    (a, pa), (b, pb) = tconv.load_cfdbench_case(case, problem), \
        jconv.load_cfdbench_case(case, problem)
    np.testing.assert_array_equal(a, b)
    assert pa == pb


def test_cfdbench_converter_matches_jax(tmp_path):
    problems = ("cavity", "tube", "cylinder", "dam")
    fake_cfdbench(tmp_path / "raw", problems)
    for mod, d in ((tconv, "port"), (jconv, "jax")):
        out = mod.convert_cfdbench(str(tmp_path / "raw"), str(tmp_path / d / "tr.hdf5"),
                                   str(tmp_path / d / "te.hdf5"), problems=problems,
                                   infer_steps=4, grid_size=8)
        assert out[0] > 0
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    case_dir = str(tmp_path / "raw" / "cavity")
    assert tconv.cfdbench_case_split(case_dir) == jconv.cfdbench_case_split(case_dir)


def test_cfdbench_helpers_match_jax():
    for mod in (tconv, jconv):
        p = dict(density=5.0, viscosity=0.01, vel_in=10.0)
        mod.normalize_physics_props(p)
        mod.normalize_bc(p, "vel_in")
        if mod is tconv:
            port_p = p
    assert port_p == p
    data = [np.random.default_rng(5).standard_normal((7, 2, 5, 6)).astype(np.float32)]
    np.testing.assert_array_equal(tconv.split_trajectory(data, 3, 8),
                                  jconv.split_trajectory(data, 3, 8))


def test_pdearena_converters_match_jax(tmp_path, monkeypatch):
    # the shallow-water converter takes its split from the directory path,
    # so the raw corpus is passed relative to it (the temporary directory's
    # own name holds 'test')
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(6)
    ns = tmp_path / "raw_ns"
    ns.mkdir()
    for split, n in (("train", 2), ("valid", 1), ("test", 2)):
        with h5py.File(ns / f"shard_{split}.h5", "w") as f:
            g = f.create_group(split)
            for k in ("u", "vx", "vy"):
                g.create_dataset(k, data=rng.standard_normal((n, 4, 6, 6)).astype(np.float32))
    sw = tmp_path / "raw_sw"
    for split, n in (("train", 2), ("test", 1)):
        (sw / split).mkdir(parents=True)
        for i in range(n):
            with h5py.File(sw / split / f"seed_{i}.nc", "w") as f:
                for k in ("u", "v", "div", "vor"):
                    f.create_dataset(k, data=rng.standard_normal((3, 1, 5, 6)))
                f.create_dataset("pres", data=rng.standard_normal((3, 5, 6)))
    for mod, d in ((tconv, "port"), (jconv, "jax")):
        assert mod.convert_pdearena_ns2d(str(ns), str(tmp_path / d / "ns")) == (3, 2)
        assert mod.convert_pdearena_shallow_water("raw_sw", str(tmp_path / d / "sw")) == (2, 1)
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_superbench_converter_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    src = tmp_path / "raw"
    (src / "pair").mkdir(parents=True)
    (src / "single").mkdir(parents=True)
    for name in ("a", "b"):
        with h5py.File(src / "pair" / f"{name}.h5", "w") as f:
            f.create_dataset("fields", data=rng.standard_normal((9, 2, 4, 5)).astype(np.float32))
    with h5py.File(src / "single" / "c.h5", "w") as f:
        f.create_dataset("fields", data=rng.standard_normal((11, 3, 4, 4)).astype(np.float32))
    written = {}
    for mod, d in ((tconv, "port"), (jconv, "jax")):
        written[d] = [os.path.relpath(p, tmp_path / d)
                      for p in mod.convert_superbench(str(src), str(tmp_path / d), time_steps=4)]
    assert written["port"] == written["jax"] and len(written["port"]) == 2
    assert_trees_equal(tmp_path / "port", tmp_path / "jax")
