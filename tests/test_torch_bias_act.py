"""The port's bias_act (dpot_tpu_torch/ops/bias_act.py and its kernel
wrapper ops/cuda/bias_act.py) against the JAX package's `bias_act_ref`.

On the CPU the wrapper runs the composition, inside the autograd Function
whose backward differentiates it again, so the forward and the first- and
second-order gradients are held to JAX here (f32, 1e-6). The CUDA kernel
itself is held to the composition on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpot_tpu.ops.bias_act import bias_act_ref as jax_bias_act
from dpot_tpu_torch.ops import bias_act as port
from dpot_tpu_torch.ops.cuda import bias_act as wrapper

ACTS = sorted(port.activation_funcs)
ROOT = Path(__file__).resolve().parents[1]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def case(seed=0, shape=(3, 5, 16)):
    rng = np.random.default_rng(seed)
    return ((2 * rng.standard_normal(shape)).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("explicit", [False, True])
def test_forward_and_two_orders_of_gradient_match_jax(act, explicit):
    """y = bias_act(x, b); L1 = sum(sin(y)); L2 = |dL1/dx|^2 + |dL1/db|^2.
    y, dL1/d(x, b) and dL2/d(x, b) within 1e-6 rel-L2 of JAX (f32 sums in
    another order)."""
    kw = dict(alpha=0.3, gain=0.7, clamp=0.8) if explicit else {}
    x, b = case()

    def l1(x, b):
        return jnp.sum(jnp.sin(jax_bias_act(x, b, act=act, **kw)))

    def l2(x, b):
        gx, gb = jax.grad(l1, argnums=(0, 1))(x, b)
        return jnp.sum(gx**2) + jnp.sum(gb**2)

    jx, jb = jnp.asarray(x), jnp.asarray(b)
    want_y = jax_bias_act(jx, jb, act=act, **kw)
    want_g1 = jax.grad(l1, argnums=(0, 1))(jx, jb)
    want_g2 = jax.grad(l2, argnums=(0, 1))(jx, jb)

    tx = torch.from_numpy(x).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = port.bias_act(tx, tb, act=act, **kw)
    assert type(y.grad_fn).__name__ == "BiasActBackward"
    g1 = torch.autograd.grad(torch.sin(y).sum(), [tx, tb], create_graph=True)
    g2 = torch.autograd.grad((g1[0] ** 2).sum() + (g1[1] ** 2).sum(), [tx, tb])
    assert rel_l2(y.detach().numpy(), want_y) <= 1e-6
    for got, want in zip((*g1, *g2), (*want_g1, *want_g2)):
        assert rel_l2(got.detach().numpy(), want) <= 1e-6


def test_no_bias_other_dim_and_empty_input():
    x, _ = case(1, (4, 6, 5))
    _, b = case(1, (6,))
    got = port.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=1, act="lrelu")
    want = jax_bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act="lrelu")
    assert rel_l2(got.numpy(), want) <= 1e-6
    got = port.bias_act(torch.from_numpy(x), act="swish", gain=2.0)
    assert rel_l2(got.numpy(), jax_bias_act(jnp.asarray(x), act="swish", gain=2.0)) <= 1e-6
    empty = torch.zeros((0, 7))
    assert port.bias_act(empty, torch.zeros(7), act="tanh").shape == (0, 7)


@pytest.mark.parametrize("xd,bd,want", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32),
])
def test_result_dtype_follows_result_type(xd, bd, want):
    x, b = case(2)
    y = port.bias_act(torch.from_numpy(x).to(xd), torch.from_numpy(b).to(bd), act="relu")
    assert y.dtype == want
    assert port.bias_act(torch.from_numpy(x).to(xd), act="relu").dtype == xd


def test_wrapper_checks_its_arguments():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="b must be"):
        port.bias_act(x, torch.zeros(3))
    with pytest.raises(ValueError, match="unknown activation"):
        port.bias_act(x, act="gelu")
    with pytest.raises(ValueError, match="clamp"):
        port.bias_act(x, clamp=-2.0)


def test_cpu_calls_are_not_launches_and_a_broken_build_raises(monkeypatch):
    """A CPU tensor runs the composition and counts no launch. The launch
    path has no fallback: with a loader that fails (a broken build), a
    launch raises the loader's error instead of computing anything."""
    before = wrapper.bias_act.launches
    port.bias_act(torch.ones(2, 3), torch.ones(3), act="tanh")
    assert wrapper.bias_act.launches == before

    from dpot_tpu_torch.ops.cuda import build

    def broken(name):
        raise RuntimeError(f"nvcc failed on {name}.cu")

    wrapper._kernel_fn.cache_clear()
    monkeypatch.setattr(build, "load_library", broken)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed on bias_act.cu"):
            wrapper._launch(torch.ones(2, 3), torch.ones(3), "tanh", 0.0, 1.0, -1.0)
    finally:
        wrapper._kernel_fn.cache_clear()
    assert wrapper.bias_act.launches == before


@pytest.mark.parametrize("module", ["ops/bias_act.py", "ops/cuda/bias_act.py",
                                    "ops/cuda/afno_fused.py"])
def test_no_try_around_a_launch(module):
    """Neither kernel module nor the op module holds a try statement, so no
    launch can fall back to the plain version."""
    tree = ast.parse((ROOT / "dpot_tpu_torch" / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))]
