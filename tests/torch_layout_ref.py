"""References of the port's layout tests (test_torch_tp.py,
test_torch_pipeline.py, test_torch_dist_fft.py), run in the pytest
process: seeded weights carried through the JAX package's layout, seeded
global batches with external noise, and the steps of one port process and
of the JAX package on a mesh of the host's CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dpot_tpu.parallel.mesh import replicate, shard_batch
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_train_step

LR, CLIP, NOISE = 1e-3, 0.5, 0.05
JAX_TOL, ONE_TOL = 2e-4, 1e-5


def rel(a, b) -> float:
    """The relative L2 distance of a from b (tensors or arrays)."""
    a, b = (torch.as_tensor(t if isinstance(t, torch.Tensor) else np.array(t),
                            dtype=torch.float64) for t in (a, b))
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def seeded_weights(cfg: dict):
    """A seeded port model's weights through the JAX package's layout: the
    JAX variables and the port state dict made back from them."""
    seeded = build_model("DPOT", device="cpu", seed=3, **cfg).state_dict()
    jvars = dpot_params_from_torch({k: v.numpy() for k, v in seeded.items()},
                                   depth=cfg["depth"], normalize=False)
    return jvars, state_dict_from_jax(jax.device_get(jvars))


def make_batches(n: int, B: int = 8, grid: int = 16, seed: int = 5) -> list[dict]:
    """n global batches (x, y of 2 rollout frames, a mask with holes, cls,
    noise for 2 steps) as numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = []
    for _ in range(n):
        msk = np.ones((B, grid, grid, 1, 2), f)
        msk[0, ::2] = 0.0
        out.append(dict(x=(1.0 + rng.standard_normal((B, grid, grid, 4, 2))).astype(f),
                        y=(1.0 + rng.standard_normal((B, grid, grid, 2, 2))).astype(f),
                        msk=msk, cls=rng.integers(0, 2, B).astype(np.int32),
                        noise=rng.standard_normal((2, B, grid, grid, 4, 2)).astype(f)))
    return out


def save_inputs(tmp, sd, batches) -> dict:
    """The weights and batches as the rank programs read them."""
    torch.save(sd, tmp / "sd.pt")
    torch.save([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
               tmp / "batches.pt")
    return dict(sd=str(tmp / "sd.pt"), batches=str(tmp / "batches.pt"), lr=LR, clip=CLIP,
                noise=NOISE)


def jax_steps(jm, jvars, batches, mesh=None, place=replicate, spatial=False, apply=None,
              lp=False, noise=NOISE):
    """The JAX package's adam steps (the clip active, external noise) on one
    device or over `mesh`, the state placed by `place(state, mesh)`: the aux
    of each step and the final params as a port state dict. `apply`
    (default jm.apply), `lp` a bf16 working copy."""
    tx = jax_build_optimizer("adam", LR, grad_clip=CLIP)
    step = jax_train_step(noise_scale=noise, donate=False)
    st = JaxTrainState.create(apply or jm.apply, jvars, tx, jax.random.key(0),
                              param_working_dtype=jnp.bfloat16 if lp else None)
    auxes = []

    def run(st, b):
        st, aux = step(st, b)
        auxes.append({k: float(np.reshape(v, ())) for k, v in aux.items()})
        return st

    if mesh is None:
        for b in batches:
            st = run(st, {k: jnp.asarray(v) for k, v in b.items()})
    else:
        with mesh:
            st = place(st, mesh)
            for b in batches:
                if spatial:  # the noise's H axis is axis 2
                    sb = shard_batch({k: v for k, v in b.items() if k != "noise"}, mesh,
                                     spatial_sharded=True)
                    sb["noise"] = jnp.asarray(b["noise"])
                else:
                    sb = shard_batch(b, mesh)
                st = run(st, sb)
    return auxes, state_dict_from_jax(jax.device_get(st.params))


def port_steps(cfg: dict, sd, batches, family="DPOT", lp=False, accum=1, noise=NOISE):
    """One port process's steps: the aux of each, the final weights, the
    last step's gradients and the forward of the first batch's x (in eval
    mode); `lp`, `accum` and `noise` as in jax_steps."""
    model = build_model(family, device="cpu", **cfg)
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(batches[0]["x"]))
    state = TrainState.create(
        model, build_optimizer("adam", model.parameters(), LR, grad_clip=CLIP), seed=0,
        param_working_dtype=torch.bfloat16 if lp else None)
    steps = {n: make_train_step(noise_scale=noise, grad_accum=n) for n in {1, accum}}
    auxes = []
    for b in batches:
        step = steps[1 if b["x"].shape[0] % accum else accum]
        state, aux = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        auxes.append({k: float(v) for k, v in aux.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return dict(aux=auxes, params=state.params_state_dict(), grads=grads, forward=pred)


def family_weights(family: str, cfg: dict, seed: int = 3):
    """A seeded port model's weights of any family through the JAX
    package's layout: the JAX model, its apply for the steps (pred-only
    models wrapped), the JAX variables and the port state dict made back
    from them."""
    from dpot_tpu.models import build_model as jax_build_model
    from dpot_tpu.train import interop as ji
    from dpot_tpu.train.step import wrap_pred_only

    seeded = {k: v.numpy() for k, v in
              build_model(family, device="cpu", seed=seed, **cfg).state_dict().items()}
    depth = cfg.get("depth", 4)
    if family == "DPOT3D":
        jvars = ji.dpot3d_params_from_torch(seeded, depth=depth)
    elif family == "CDPOT":
        jvars = ji.cdpot_params_from_torch(seeded, depth=depth)
    elif family == "FNO":
        jvars = ji.fno2d_params_from_torch(seeded, n_layers=depth)
    elif family == "UNet":
        jvars = ji.unet_params_from_torch({k: v.copy() for k, v in seeded.items()})
    else:
        jvars = dpot_params_from_torch(seeded, depth=depth, normalize=False)
    jm = jax_build_model(family, **cfg)
    apply = wrap_pred_only(jm.apply) if family == "DPOT3D" else jm.apply
    return jm, apply, jvars, state_dict_from_jax(jax.device_get(jvars))


def assert_run(got: dict, want_aux: list, want_params: dict, tol: float, what) -> None:
    """A rank's steps (losses, grad norms, the gathered weights) against a
    reference's, relative."""
    for s, (a, w) in enumerate(zip(got["aux"], want_aux, strict=True)):
        for k in ("loss_step", "loss_full", "grad_norm"):
            assert abs(a[k] - w[k]) <= tol * abs(w[k]), (what, s, k, a[k], w[k])
    assert sorted(got["params"]) == sorted(want_params)
    for name, v in want_params.items():
        assert rel(got["params"][name], v) <= tol, (what, name)
