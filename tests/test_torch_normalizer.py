"""The port's normalizers (dpot_tpu_torch/utils/normalizer.py) against the
JAX package's on the same numpy-seeded fields: every transformer's
transform and inverse, and the differentiable quantile transform's values
and gradient (torch autograd against jax.grad), within 1e-5 relative (of
the reference's largest magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpot_tpu.utils.normalizer as jnorm
import dpot_tpu_torch.utils.normalizer as tnorm

REL = 1e-5


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * max(np.abs(want).max(), 1e-30))


def fields(seed=0):
    rng = np.random.default_rng(seed)
    fit = (rng.standard_normal((6, 8, 8, 5, 3)) * [1.0, 3.0, 0.2] + [0.0, 2.0, -1.0])
    return fit.astype(np.float32), rng.standard_normal((2, 8, 8, 5, 3)).astype(np.float32)


NUMPY_KINDS = [("unit", {}), ("minmax", {}), ("pointwise", {}),
               ("pointwise", {"temporal": False}), ("quantile", {"n_quantiles": 50}),
               ("identity", {})]


# the quantile transformer has no per-component form
CASES = [(k, kw, c) for k, kw in NUMPY_KINDS for c in ("all", 1)
         if not (k == "quantile" and c != "all")]


@pytest.mark.parametrize("kind,kw,component", CASES, ids=lambda v: str(v))
def test_numpy_transformers_match_jax(kind, kw, component):
    fit, x = fields()
    t, j = tnorm.init_normalizer(kind, fit, **kw), jnorm.init_normalizer(kind, fit, **kw)
    xc = x if component == "all" else x[..., component]
    for inverse in (False, True):
        close(t.transform(xc, inverse=inverse, component=component),
              j.transform(xc, inverse=inverse, component=component))
    if kind not in ("identity", "quantile"):  # quantiles clamp outside the fit's range
        back = t.transform(t.transform(xc, inverse=False, component=component),
                           inverse=True, component=component)
        np.testing.assert_allclose(back, xc, rtol=1e-4, atol=1e-4)


def test_unit_stats_match_jax():
    fit, _ = fields(1)
    t, j = tnorm.UnitTransformer(fit), jnorm.UnitTransformer(fit)
    close(t.mean, j.mean)
    close(t.std, j.std)
    assert t.mean.shape == (1, 1, 1, 1, 3)


def test_fit_quantiles_match_jax():
    fit, _ = fields(2)
    for a, b in zip(tnorm.fit_quantiles(fit, 64), jnorm.fit_quantiles(fit, 64)):
        close(a, b)


@pytest.mark.parametrize("dist", ["normal", "uniform"])
@pytest.mark.parametrize("inverse", [False, True])
def test_differentiable_quantile_values_and_gradient(dist, inverse):
    fit, x = fields(3)
    if inverse:
        x = x if dist == "normal" else 1.0 / (1.0 + np.exp(-x))
    t = tnorm.DifferentiableQuantileTransformer(fit, output_distribution=dist, n_quantiles=64)
    j = jnorm.DifferentiableQuantileTransformer(fit, output_distribution=dist, n_quantiles=64)
    assert t.clip_min == pytest.approx(j.clip_min, rel=1e-12)
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    xt = torch.tensor(x, requires_grad=True)
    out_t = t.transform(xt, inverse=inverse)
    (out_t * torch.from_numpy(w)).sum().backward()

    def f(xj):
        return jnp.sum(j.transform(xj, inverse=inverse) * w)

    out_j = j.transform(jnp.asarray(x), inverse=inverse)
    grad_j = jax.grad(f)(jnp.asarray(x))
    close(out_t.detach().numpy(), np.asarray(out_j))
    close(xt.grad.numpy(), np.asarray(grad_j))
    assert np.isfinite(xt.grad.numpy()).all()


def test_interp1d_gradients_match_jax():
    rng = np.random.default_rng(5)
    xk = np.sort(rng.standard_normal(12)).astype(np.float32)
    yk = rng.standard_normal(12).astype(np.float32)
    xn = (rng.standard_normal(40) * 1.5).astype(np.float32)  # extrapolates too
    xt, yt, nt = (torch.tensor(a, requires_grad=True) for a in (xk, yk, xn))
    out = tnorm.interp1d(xt, yt, nt)
    out.sum().backward()
    want = jnorm.interp1d(jnp.asarray(xk), jnp.asarray(yk), jnp.asarray(xn))
    grads = jax.grad(lambda a, b, c: jnorm.interp1d(a, b, c).sum(), argnums=(0, 1, 2))(
        jnp.asarray(xk), jnp.asarray(yk), jnp.asarray(xn))
    close(out.detach().numpy(), np.asarray(want))
    for g, gj in zip((xt.grad, yt.grad, nt.grad), grads):
        close(g.numpy(), np.asarray(gj))


def test_init_normalizer_knows_every_kind():
    fit, _ = fields(6)
    for kind in ("unit", "minmax", "pointwise", "quantile", "quantile_diff", "identity",
                 "none"):
        assert type(tnorm.init_normalizer(kind, fit)).__name__ == \
            type(jnorm.init_normalizer(kind, fit)).__name__
