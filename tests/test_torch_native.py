"""The port's host preprocessing library (dpot_tpu_torch/native) against the
JAX package's build of the same arithmetic (same source arithmetic, flags
and host: bit for bit), against its own plain numpy versions (1e-5 for the
resizes, bit for bit for the assembly and the bf16 rounding) and against
ml_dtypes' bf16 rounding; the build's failure modes and its lock."""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import dpot_tpu.native.preprocess as jax_pre
from dpot_tpu.native.build import native_available as jax_native_available
from dpot_tpu_torch.native import build
from dpot_tpu_torch.native import preprocess as pre

ROOT = Path(__file__).resolve().parents[1]
RESIZE_TOL = 1e-5


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    """Both libraries on, each call on two threads (the port's follows
    torch's thread count, the JAX package's DPOT_NATIVE_THREADS)."""
    monkeypatch.delenv("DPOT_DISABLE_NATIVE", raising=False)
    monkeypatch.setenv("DPOT_NATIVE_THREADS", "2")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, port call, JAX call) on the same input: the shapes of the smoke's
# checks, cut to CPU size
CASES = {
    "pad_64_to_128_c1_to_c4": (lambda x: pre.pad_data_2d(x, 32, 4),
                               lambda x: jax_pre.pad_data_2d(x, 32, 4), (16, 16, 5, 1)),
    "pad_96_to_128_c3_to_c4": (lambda x: pre.pad_data_2d(x, 16, 4),
                               lambda x: jax_pre.pad_data_2d(x, 16, 4), (12, 12, 5, 3)),
    # no resize: both wrappers pad in numpy and never call the library
    "pad_same_size_c3_to_c4": (lambda x: pre.pad_data_2d(x, 16, 4),
                               lambda x: jax_pre.pad_data_2d(x, 16, 4), (16, 16, 5, 3)),
    "pad_ragged": (lambda x: pre.pad_data_2d(x, 24, 3),
                   lambda x: jax_pre.pad_data_2d(x, 24, 3), (37, 41, 3, 2)),
    "bilinear": (lambda x: pre.resize_bilinear_2d(x, (32, 48)),
                 lambda x: jax_pre.resize_bilinear_2d(x, (32, 48)), (19, 23, 6)),
    "trilinear_48_to_64": (lambda x: pre.resize_trilinear_3d(x, (16, 16, 16)),
                           lambda x: jax_pre.resize_trilinear_3d(x, (16, 16, 16)),
                           (12, 12, 12, 2, 3)),
}


def plain(fn, x, monkeypatch):
    monkeypatch.setenv("DPOT_DISABLE_NATIVE", "1")
    try:
        return fn(x)
    finally:
        monkeypatch.delenv("DPOT_DISABLE_NATIVE")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_equals_jax_native_bitwise(case):
    port_fn, jax_fn, shape = CASES[case]
    assert jax_native_available(), "the JAX package's native library did not build"
    x = field(shape, 1)
    got, want = port_fn(x), jax_fn(x)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_against_plain_version(case, monkeypatch):
    port_fn, _, shape = CASES[case]
    x = field(shape, 2)
    got = port_fn(x)
    want = plain(port_fn, x, monkeypatch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RESIZE_TOL, atol=RESIZE_TOL)


def special_field(n, seed):
    """Random f32 with +-0, +-inf, NaNs (quiet, signalling, with payloads),
    subnormals, the largest finite values and exact rounding ties in it."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-30, 30, n))).astype(np.float32)
    u = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
                  0x7F800001, 0x7FA00000, 0x00000001, 0x807FFFFF, 0x00400000, 0x7F7FFFFF,
                  0xFF7FFFFF, 0x3F808000, 0x3F818000, 0x3F80C000, 0x3F807FFF, 0x7F7F8000],
                 np.uint32)
    idx = rng.choice(n, size=len(u), replace=False)
    x.view(np.uint32)[idx] = u
    return x


def assert_bf16_like_ml_dtypes(words: np.ndarray, x: np.ndarray) -> None:
    """Bit for bit with ml_dtypes except NaN payloads: ml_dtypes writes the
    canonical quiet NaN, the library (as the JAX package's) keeps the
    payload's high bits and sets the quiet bit; both keep a NaN a NaN of
    the same sign."""
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(words[~nan], want[~nan])
    w = words[nan]
    assert ((w & 0x7F80) == 0x7F80).all() and ((w & 0x0040) != 0).all()
    np.testing.assert_array_equal(w >> 15, want[nan] >> 15)


def test_bf16_plain_equals_ml_dtypes():
    x = special_field(4099, 3)
    assert_bf16_like_ml_dtypes(pre.f32_to_bf16_bits(x), x)


def test_bf16_truncation_would_be_caught():
    """The comparison above sees a conversion that truncates."""
    x = special_field(4099, 3)
    truncated = (x.view(np.uint32) >> 16).astype(np.uint16)
    assert (truncated != pre.f32_to_bf16_bits(x)).sum() > 100


def windows(n, x_elems, y_elems, seed):
    return [special_field(x_elems + y_elems, seed + j) for j in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assemble_windows_native_plain_and_jax(dtype, monkeypatch):
    n, xs, ys = 5, (3, 8, 8, 2), (1, 8, 8, 2)
    srcs = windows(n, int(np.prod(xs)), int(np.prod(ys)), 10)

    def run():
        if dtype == "float32":
            ox, oy = np.empty((n, *xs), np.float32), np.empty((n, *ys), np.float32)
            pre.assemble_windows(srcs, ox, oy)
            return ox.view(np.uint32), oy.view(np.uint32)
        tx, ty = torch.empty((n, *xs), dtype=torch.bfloat16), torch.empty((n, *ys),
                                                                          dtype=torch.bfloat16)
        pre.assemble_windows(srcs, pre.bf16_words(tx), pre.bf16_words(ty))
        return pre.bf16_words(tx), pre.bf16_words(ty)

    native = run()
    plain_out = plain(lambda _: run(), None, monkeypatch)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    jx, jy = np.empty((n, *xs), jdt), np.empty((n, *ys), jdt)
    ptrs = np.array([s.ctypes.data for s in srcs], np.uint64)
    assert jax_pre.assemble_windows(ptrs, jx, jy)
    wide = np.uint32 if dtype == "float32" else np.uint16
    for got, p, j in zip(native, plain_out, (jx, jy)):
        np.testing.assert_array_equal(got, p)
        np.testing.assert_array_equal(got, j.view(wide))
    if dtype == "bfloat16":
        flat = np.stack(srcs)[:, :int(np.prod(xs))]
        assert_bf16_like_ml_dtypes(native[0].reshape(n, -1), flat)


def test_copy_to_bf16_from_strided_items():
    x = special_field(2 * 6 * 5, 4).reshape(2, 6, 5)
    want = pre.f32_to_bf16_bits(x)
    dst = np.zeros((2, 6, 5), np.uint16)
    pre.copy_to_bf16(dst, x)
    np.testing.assert_array_equal(dst, want)
    pre.copy_to_bf16(dst, x[:, ::-1])
    np.testing.assert_array_equal(dst, want[:, ::-1])
    assert_bf16_like_ml_dtypes(pre.f32_to_bf16_bits(x), x)
    with pytest.raises(ValueError, match="C-contiguous"):
        pre.copy_to_bf16(np.zeros((2, 6, 10), np.uint16)[..., ::2], x)


def test_assemble_windows_refuses_bad_sources():
    ox, oy = np.empty((1, 4), np.float32), np.empty((1, 2), np.float32)
    with pytest.raises(ValueError, match="contiguous float32"):
        pre.assemble_windows([np.zeros(5, np.float32)], ox, oy)
    with pytest.raises(ValueError, match="float32 or uint16"):
        pre.assemble_windows([np.zeros(6, np.float32)], ox.astype(np.float64), oy)


@pytest.mark.parametrize("native", [True, False])
def test_pad_refuses_channel_truncation(native, monkeypatch):
    if not native:
        monkeypatch.setenv("DPOT_DISABLE_NATIVE", "1")
    with pytest.raises(ValueError, match="TRUNCATION"):
        pre.pad_data_2d(field((8, 8, 2, 5), 5), 16, 4)


def test_disable_native_is_read_on_every_call(monkeypatch):
    assert build.get_library() is not None
    monkeypatch.setenv("DPOT_DISABLE_NATIVE", "1")
    assert build.get_library() is None
    monkeypatch.setenv("DPOT_DISABLE_NATIVE", "0")
    assert build.get_library() is not None


def test_library_is_keyed_on_the_host_cpu(monkeypatch):
    a = build.library_path()
    monkeypatch.setattr(build, "cpu_identity", lambda: "another cpu|avx")
    assert build.library_path() != a
    assert a.parent == ROOT / "build" / "dpot_tpu_torch" / "native"


def test_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        build.build_library(cxx=str(tmp_path / "no-such-g++"), build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_failed_build_raises_with_compiler_output(tmp_path):
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'preprocess.cc:1: error: broken on purpose' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken on purpose"):
        build.build_library(cxx=str(fake), build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so*"))


def test_two_processes_building_at_once_share_one_library(tmp_path):
    code = ("import ctypes, sys; from dpot_tpu_torch.native import build; "
            "p = build.build_library(build_dir=sys.argv[1]); ctypes.CDLL(str(p)); print(p)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.glob("*.so*")] == [Path(paths.pop()).name]
