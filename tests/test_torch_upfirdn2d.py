"""The port's upfirdn2d family and filtered_lrelu (dpot_tpu_torch/ops/
upfirdn2d.py) against the JAX package's (dpot_tpu/ops/upfirdn2d.py) on the
CPU, where filtered_lrelu's middle step is bias_act's plain composition:
the same numpy-seeded inputs through both, max abs error <= 1e-5 in f32,
forward and first-order gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.ops import upfirdn2d as jx
from dpot_tpu_torch.ops import upfirdn2d as pt
from dpot_tpu_torch.ops.cuda.bias_act import bias_act

TOL = 1e-5
TAPS4 = [1.0, 3.0, 3.0, 1.0]
TAPS12 = np.hanning(14)[1:-1].astype(np.float32)  # a 12-tap lowpass, separable


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL, err


@pytest.mark.parametrize("taps,kw", [(TAPS4, {}), (TAPS4, dict(flip_filter=True, gain=3.0)),
                                     (TAPS12, {}), (TAPS12, dict(separable=False)),
                                     ([2.0], {}), (None, {})])
def test_setup_filter_matches_jax(taps, kw):
    close(pt.setup_filter(taps, **kw), jx.setup_filter(taps, **kw))


FILTERS = {
    "dense4": lambda: np.outer(TAPS4, TAPS4).astype(np.float32) / 64.0,
    "dense3x5": lambda: inputs((3, 5), 9),
    "separable8": lambda: np.array([1, 2, 4, 6, 6, 4, 2, 1], np.float32) / 26.0,
    "separable12": lambda: TAPS12 / TAPS12.sum(),
    "none": lambda: None,
}


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1, 1, 1)), (2, 1, (2, 1, 2, 1)),
                                         (1, 2, (1, 1, 1, 1)), (2, 2, (2, 2, 2, 2)),
                                         ((2, 1), (1, 2), (3, -1, 0, 2)),
                                         (3, 2, (-2, 4, 1, -1))])
@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("flip", [False, True])
def test_upfirdn2d_matches_jax(filt, up, down, pad, flip):
    """Dense and separable filters, up/down/pad cases as in the JAX
    package's tests/test_native_ops.py, negative padding (a crop) and
    unequal factors; flip_filter both ways."""
    x = inputs((2, 13, 11, 3), 2)
    f = FILTERS[filt]()
    got = pt.upfirdn2d(torch.from_numpy(x), None if f is None else torch.from_numpy(f),
                       up=up, down=down, padding=list(pad), flip_filter=flip, gain=2.0)
    want = jx.upfirdn2d(jnp.asarray(x), None if f is None else jnp.asarray(f), up=up,
                        down=down, padding=list(pad), flip_filter=flip, gain=2.0)
    close(got, want)


@pytest.mark.parametrize("taps", [TAPS4, TAPS12])
@pytest.mark.parametrize("fn,kw", [("filter2d", dict(padding=1)),
                                   ("upsample2d", dict(up=2)),
                                   ("upsample2d", dict(up=(2, 1), padding=(1, 0, 2, 1))),
                                   ("downsample2d", dict(down=2)),
                                   ("downsample2d", dict(down=2, padding=2, gain=0.5))])
def test_wrappers_match_jax(fn, kw, taps):
    x = inputs((1, 12, 10, 2), 4)
    got = getattr(pt, fn)(torch.from_numpy(x), pt.setup_filter(taps), **kw)
    want = getattr(jx, fn)(jnp.asarray(x), jx.setup_filter(taps), **kw)
    close(got, want)


LRELU_CASES = {
    # name: (fu, fd, up, down, padding, clamp)
    "separable12_up2_down2": (TAPS12, TAPS12, 2, 2, (12, 10, 12, 10), None),
    "separable12_clamp": (TAPS12, TAPS12, 2, 2, (12, 10, 12, 10), 0.5),
    "dense4_up2_down2": (TAPS4, TAPS4, 2, 2, (2, 1, 2, 1), None),
    "dense4_clamp": (TAPS4, TAPS4, 2, 2, (2, 1, 2, 1), 0.5),
    "identity": (None, None, 1, 1, 0, None),
}


def lrelu_pair(case, seed=5):
    fu, fd, up, down, pad, clamp = LRELU_CASES[case]
    x, b = inputs((2, 8, 8, 4), seed), inputs((4,), seed + 1)
    kw = dict(up=up, down=down, padding=pad, clamp=clamp, slope=0.2)
    tf = [None if f is None else pt.setup_filter(f) for f in (fu, fd)]
    jf = [None if f is None else jx.setup_filter(f) for f in (fu, fd)]
    return x, b, kw, tf, jf


@pytest.mark.parametrize("case", list(LRELU_CASES))
def test_filtered_lrelu_matches_jax(case):
    """Forward, and the same padding giving the input's grid (8 -> 16 ->
    8) where the filters are centred; the CPU path runs bias_act's plain
    composition, and launches no kernel."""
    x, b, kw, tf, jf = lrelu_pair(case)
    before = bias_act.launches
    got = pt.filtered_lrelu(torch.from_numpy(x), *tf, torch.from_numpy(b), **kw)
    want = jx.filtered_lrelu(jnp.asarray(x), *jf, jnp.asarray(b), **kw)
    close(got, want)
    assert bias_act.launches == before
    if case.startswith("separable12"):
        assert got.shape == (2, 8, 8, 4)


@pytest.mark.parametrize("case", ["separable12_up2_down2", "separable12_clamp",
                                  "dense4_clamp"])
def test_filtered_lrelu_gradient_matches_jax(case):
    """d<g, filtered_lrelu(x, b)>/d(x, b) against jax.grad."""
    x, b, kw, tf, jf = lrelu_pair(case, seed=7)
    out_shape = jx.filtered_lrelu(jnp.asarray(x), *jf, jnp.asarray(b), **kw).shape
    g = inputs(out_shape, 8)
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = pt.filtered_lrelu(xt, *tf, bt, **kw)
    gx, gb = torch.autograd.grad(y, [xt, bt], torch.from_numpy(g))

    def loss(xj, bj):
        return jnp.sum(jx.filtered_lrelu(xj, *jf, bj, **kw) * g)

    jgx, jgb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    close(gx, jgx)
    close(gb, jgb)
