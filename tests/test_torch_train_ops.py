"""The port's training ops against the JAX package: the losses, the
schedules, the optimizers and the gradient of the fused GroupNorm+AFNO op.

Inputs come from numpy seeds and go to both packages. The JAX TPU kernel
runs in interpret mode with f32 operands, as the JAX package's own tests run
it on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dpot_tpu_torch.ops.cuda import afno_fused as port_afno
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes
from dpot_tpu_torch.train import optimizers as port_opt
from dpot_tpu_torch.train import schedules as port_sched
from dpot_tpu_torch.utils.criterion import cross_entropy_sum, rel_lp_loss


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True])
def test_rel_lp_loss_matches_jax(masked):
    """Summed over the batch, divided by the count of unmasked channels,
    with the +1e-8 guard (one sample has an all-zero target). 1e-6 rel."""
    from dpot_tpu.utils.criterion import rel_lp_loss as jax_loss

    rng = np.random.default_rng(0)
    pred = rng.standard_normal((3, 8, 8, 2, 4)).astype(np.float32)
    tgt = rng.standard_normal((3, 8, 8, 2, 4)).astype(np.float32)
    tgt[1] = 0.0
    msk = None
    if masked:
        msk = np.ones((3, 8, 8, 1, 4), np.float32)
        msk[0, ..., 3] = 0.0
        msk[2, ::2] = 0.0
    for reduce in (True, False):
        got = rel_lp_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                          None if msk is None else torch.from_numpy(msk),
                          reduce_batch=reduce).numpy()
        want = np.asarray(jax_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                   None if msk is None else jnp.asarray(msk),
                                   reduce_batch=reduce))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_entropy_sum_matches_jax():
    from dpot_tpu.utils.criterion import cross_entropy_sum as jax_ce

    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((6, 5))).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    got = cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("method", ["cycle", "step", "warmup", "linear", "restart", "cyclic"])
def test_schedules_match_jax(method):
    """Every step of a short run (4 steps/epoch, 6 epochs): 1e-6 relative.
    The JAX schedules compute in f32, the port in f64; where the OneCycle
    formula cancels (lr near max_lr / 1e4) f32 keeps about 1e-6 of max_lr,
    so the absolute limit is 1e-6 * max_lr = 1e-9."""
    from dpot_tpu.train.schedules import build_schedule

    kw = dict(warmup_epochs=2, step_size=1, step_gamma=0.5, lr_step_size=1)
    got = port_sched.build_schedule(method, 1e-3, 4, 6, **kw)
    want = build_schedule(method, 1e-3, 4, 6, **kw)
    steps = range(4 * 6 + 1)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6, atol=1e-9)


def test_onecycle_momentum_matches_jax():
    from dpot_tpu.train.schedules import onecycle_momentum

    got = port_sched.onecycle_momentum(30, 2, 6)
    want = onecycle_momentum(30, 2, 6)
    np.testing.assert_allclose([got(s) for s in range(31)],
                               [float(want(s)) for s in range(31)], rtol=1e-6)


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name", ["adam", "adamw", "lamb"])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_optimizers_match_jax(name, moment):
    """Five updates on shared gradients with a cycled b1, a OneCycle lr, an
    active clip and (one case) a bf16 first moment: the params within 1e-6
    relative, the pre-clip grad norm within 1e-6 relative."""
    import optax

    from dpot_tpu.train.optimizers import build_optimizer
    from dpot_tpu.train.schedules import onecycle, onecycle_momentum

    rng = np.random.default_rng(2)
    shapes = {"a": (4, 6), "b": (6,), "c": (2, 3, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    kw = dict(beta2=0.9, grad_clip=2.0, weight_decay=1e-2)
    tx = build_optimizer(name, onecycle(1e-2, 5, 1, 3), onecycle_momentum(5, 1, 3),
                         moment_dtype=jnp.bfloat16 if moment == "bfloat16" else None, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = port_opt.build_optimizer(
        name, params.values(), port_sched.onecycle(1e-2, 5, 1, 3),
        port_sched.onecycle_momentum(5, 1, 3),
        moment_dtype=torch.bfloat16 if moment == "bfloat16" else None, **kw)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        np.testing.assert_allclose(opt.grad_norm.item(), float(st.grad_norm), rtol=1e-6)
    assert opt.count == 5 and opt.mu[0].dtype == getattr(torch, moment)
    for k, p in params.items():
        assert rel_l2(p.detach().numpy(), jp[k]) <= 1e-6, k


def test_optimizer_state_round_trip_and_no_grad_counts_as_zero():
    """A parameter without .grad is updated as with a zero gradient (coupled
    decay still moves it); state_dict/load_state_dict restore the moments."""
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    opt = port_opt.adam([p, q], 1e-2, weight_decay=0.5)
    p.grad = torch.full((3,), 0.1)
    opt.step()
    assert not torch.equal(q.detach(), torch.ones(2))
    sd = {k: (list(v) if isinstance(v, list) else v) for k, v in opt.state_dict().items()}
    sd = {"count": sd["count"], "mu": [m.clone() for m in sd["mu"]],
          "nu": [v.clone() for v in sd["nu"]], "grad_norm": sd["grad_norm"].clone()}
    opt2 = port_opt.adam([torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))],
                         1e-2, weight_decay=0.5)
    opt2.load_state_dict(sd)
    assert opt2.count == 1
    for a, b in zip(opt.mu + opt.nu, opt2.mu + opt2.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- fused_gn_afno gradient


def afno_case(B=2, H=8, W=8, C=128, nb=2, modes=4, groups=8, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    bs = C // nb
    f = np.float32
    return dict(
        x=rng.standard_normal((B, H * W, C)).astype(f),
        gs=(1.0 + 0.1 * rng.standard_normal(C)).astype(f),
        gb=(0.1 * rng.standard_normal(C)).astype(f),
        w1=(scale * rng.standard_normal((2, nb, bs, bs))).astype(f),
        b1=(scale * rng.standard_normal((2, nb, bs))).astype(f),
        w2=(scale * rng.standard_normal((2, nb, bs, bs))).astype(f),
        b2=(scale * rng.standard_normal((2, nb, bs))).astype(f),
        g=rng.standard_normal((B, H * W, C)).astype(f),
        H=H, W=W, modes=modes, groups=groups, nb=nb,
    )


def port_args(c, requires_grad=False):
    kh, kw = kept_modes(c["H"], c["W"], c["modes"])
    A, Ainv = combined_spectral_ops(c["H"], c["W"], kh, kw, torch.float32,
                                    torch.device("cpu"))
    t = {k: torch.from_numpy(c[k].copy()).requires_grad_(requires_grad)
         for k in ("x", "gs", "gb", "w1", "b1", "w2", "b2")}
    return (t["x"], t["gs"], t["gb"], A, Ainv, t["w1"], t["b1"], t["w2"], t["b2"],
            kh * kw, c["groups"])


def real_form_to_ref(gW, bs):
    """Cotangent of the real form [[wr, wi], [-wi, wr]] -> (2, nb, bs, bs)."""
    gW = np.asarray(gW)
    return np.stack([gW[:, :bs, :bs] + gW[:, bs:, bs:], gW[:, :bs, bs:] - gW[:, bs:, :bs]])


def test_vjp_matches_jax_vjp_of_the_tpu_kernel(monkeypatch):
    """The port's VJP (tanh, f32) against jax.vjp of the TPU kernel in
    interpret mode (whose backward recomputes through _xla_reference), for
    x, gscale, gbias, W1, B1, W2, B2; the JAX real-form weight cotangents
    are mapped to the reference layout. <= 1e-5 rel-L2 each."""
    monkeypatch.setenv("DPOT_PALLAS_INTERPRET", "1")
    from dpot_tpu.ops.pallas.afno_fused import fused_gn_afno as jax_fused
    from dpot_tpu.ops.spectral import _combined_spectral_ops, _complex_as_real_weight

    c = afno_case()
    bs = c["x"].shape[-1] // c["nb"]
    kh, kw = kept_modes(c["H"], c["W"], c["modes"])
    A, Ainv = _combined_spectral_ops(c["H"], c["W"], kh, kw)
    w1, b1, w2, b2 = (jnp.asarray(c[k]) for k in ("w1", "b1", "w2", "b2"))
    primals = (
        jnp.asarray(c["x"]), jnp.asarray(c["gs"])[None], jnp.asarray(c["gb"])[None],
        jnp.asarray(A), jnp.asarray(Ainv),
        _complex_as_real_weight(w1[0], w1[1]), jnp.concatenate([b1[0], b1[1]], -1)[:, None],
        _complex_as_real_weight(w2[0], w2[1]), jnp.concatenate([b2[0], b2[1]], -1)[:, None],
    )
    _, vjp = jax.vjp(lambda *a: jax_fused(*a, kh * kw, c["groups"]), *primals)
    jg = vjp(jnp.asarray(c["g"]))
    want = {
        "x": jg[0], "gs": jg[1][0], "gb": jg[2][0],
        "w1": real_form_to_ref(jg[5], bs),
        "b1": np.stack([jg[6][:, 0, :bs], jg[6][:, 0, bs:]]),
        "w2": real_form_to_ref(jg[7], bs),
        "b2": np.stack([jg[8][:, 0, :bs], jg[8][:, 0, bs:]]),
    }
    a = port_args(c)
    got = port_afno.fused_gn_afno_vjp(torch.from_numpy(c["g"]), *a[:9], a[9], a[10], True)
    for name, g in zip(("x", "gs", "gb", "w1", "b1", "w2", "b2"), got):
        assert rel_l2(g.numpy(), want[name]) <= 1e-5, name


def test_vjp_erf_matches_autograd_through_the_plain_version():
    """erf-GELU, f32: the VJP against torch.autograd through
    fused_gn_afno_ref. <= 1e-5 rel-L2 each."""
    c = afno_case(B=3, H=4, W=8, C=64, nb=4, modes=3, groups=4, seed=1, scale=0.3)
    a = port_args(c, requires_grad=True)
    out = port_afno.fused_gn_afno_ref(*a[:9], a[9], a[10], False)
    inputs = [a[i] for i in (0, 1, 2, 5, 6, 7, 8)]
    want = torch.autograd.grad(out, inputs, torch.from_numpy(c["g"]))
    got = port_afno.fused_gn_afno_vjp(torch.from_numpy(c["g"]),
                                      *(t.detach() for t in a[:9]), a[9], a[10], False)
    for g, w in zip(got, want):
        assert rel_l2(g.numpy(), w.numpy()) <= 1e-5


def test_autograd_function_backward_never_runs_the_plain_forward(monkeypatch):
    """With grads on, the wrapper returns a FusedGnAfno node; its backward is
    the VJP alone: with the plain version made to raise after the forward,
    backward still gives the VJP's gradients."""
    c = afno_case(seed=2)
    a = port_args(c, requires_grad=True)
    out = port_afno.fused_gn_afno(*a)
    assert type(out.grad_fn).__name__ == "FusedGnAfnoBackward"

    def boom(*args, **kwargs):
        raise AssertionError("the plain version ran in the backward")

    monkeypatch.setattr(port_afno, "fused_gn_afno_ref", boom)
    g = torch.from_numpy(c["g"])
    inputs = [a[i] for i in (0, 1, 2, 5, 6, 7, 8)]
    got = torch.autograd.grad(out, inputs, g)
    want = port_afno.fused_gn_afno_vjp(g, *(t.detach() for t in a[:9]), a[9], a[10])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with torch.inference_mode():
        monkeypatch.undo()
        assert port_afno.fused_gn_afno(*port_args(c)).grad_fn is None


def test_afno2d_forward_on_cpu_goes_through_the_function():
    from dpot_tpu_torch.models.dpot import AFNO2D, GroupNorm

    gen = torch.Generator().manual_seed(0)
    mixer, norm = AFNO2D(32, 4, 4, gen), GroupNorm(8, 32)
    out = mixer(torch.randn(2, 8, 8, 32, generator=gen), norm)
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    assert "FusedGnAfnoBackward" in {type(f).__name__ for f in seen}
    out.sum().backward()
    for p in (mixer.w1, mixer.b1, mixer.w2, mixer.b2, norm.weight, norm.bias):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
