"""The other model families over the port's mesh axes, on 2 gloo ranks on the
CPU: UNet's BatchNorm over 'data' (DDP and FSDP2, grad_accum 2 and an
uneven 5-row tail; dpot_tpu_torch/models/unet.py `sync_batch_stats`),
DPOT3D and CDPOT under tensor parallelism (JAX's name-keyed rules,
tests/test_tp.py:133), and FNO2d and UNet over a 'model' axis that no rule
reaches (every leaf replicated, as JAX falls back, tests/test_tp.py:62).

One launch (tests/torch_dist_cases.py, under a 120 s limit), started before
the references so that the ranks run while the JAX package's steps
compile. Each family's seeded weights are carried through the JAX
package's layout. DPOT3D, CDPOT and FNO: two adam steps with the clip
active and external noise, every rank's losses, grad norms and gathered
weights within 1e-5 of one port process and 2e-4 of the JAX package's
layout (its model = 2 mesh under shard_state_tp). UNet: one step from the
seeded weights on the 8-row batch (grad_accum 2) and one on the 5-row tail,
each rank's losses, grad norm and running statistics within 1e-5 of one
port process and 2e-4 of the JAX package's step on its data = 2 mesh, and
its gradients within 1e-4 of both (GRAD_TOL below)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_dist_cases import start
from torch_layout_ref import (JAX_TOL, ONE_TOL, assert_run, family_weights, jax_steps,
                              port_steps, rel)

from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu.parallel.mesh import replicate, shard_batch
from dpot_tpu.parallel.tensor import count_tp_leaves as jax_count_tp_leaves
from dpot_tpu.parallel.tensor import shard_state_tp as jax_tp
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.parallel.tensor import count_tp_leaves
from dpot_tpu_torch.train.interop import state_dict_from_jax

pytestmark = pytest.mark.multichip

CFGS = {
    "UNet": dict(img_size=16, in_channels=2, out_channels=2, in_timesteps=4,
                 out_layer_dim=4, n_cls=2),
    "FNO": dict(img_size=16, patch_size=1, in_channels=2, in_timesteps=4, embed_dim=16,
                depth=2, modes=4, n_cls=2),
    "DPOT3D": dict(img_size=8, patch_size=2, in_channels=2, out_channels=2, in_timesteps=4,
                   out_timesteps=1, embed_dim=16, depth=2, n_blocks=4, modes=2,
                   temporal_modes=2, out_layer_dim=8, n_cls=1),
    "CDPOT": dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
                  out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4,
                  out_layer_dim=8, n_cls=2),
}
# name: (family and its batches, mesh axes, shard_params, grad_accum)
LAYOUTS = {
    "unet_ddp_accum": ("UNet_accum", dict(data=2), "replicate", 2),
    "unet_ddp_tail": ("UNet_tail", dict(data=2), "replicate", 2),
    "unet_fsdp_accum": ("UNet_accum", dict(data=2), "fsdp", 2),
    "unet_fsdp_tail": ("UNet_tail", dict(data=2), "fsdp", 2),
    "unet_model": ("UNet_accum", dict(model=2), "tp", 2),
    "fno_model": ("FNO", dict(model=2), "tp", 1),
    "dpot3d_tp": ("DPOT3D", dict(model=2), "tp", 1),
    "cdpot_tp": ("CDPOT", dict(model=2), "tp", 1),
}
NOISE = 0.05
# UNet's gradients against one port process. f32 summation orders differ
# between processes (the ranks run one thread, and sum over ranks): UNet
# on 'model' = 2, whose ranks compute exactly one process's arithmetic,
# showed 1.5e-4 and 2.9e-4 on two BatchNorm biases' gradients after one
# adam step (their sums cancel), and Adam's sign-like first updates carry
# such differences of near-zero gradients into the weights, so the weights
# are not held at 1e-5 leaf by leaf; 1e-4 is the port's UNet gradient bar
# against JAX (tests/test_torch_families_step.py)
GRAD_TOL = 1e-4


def family_batches(family: str, seed: int) -> list[dict]:
    """The global batches of a family's grid: UNet's one of 8 rows
    (grad_accum splits it) or of 5 (the tail that does not divide over 2
    ranks), without noise draws; the others' two of 4 rows with external
    noise for their 2 rollout steps."""
    grid = (8, 8, 8) if family == "DPOT3D" else (16, 16)
    rng = np.random.default_rng(seed)
    f = np.float32
    out = []
    sizes = {"UNet_accum": (8,), "UNet_tail": (5,)}.get(family, (4, 4))
    for B in sizes:
        msk = np.ones((B, *grid, 1, 2), f)
        msk[0, ::2] = 0.0
        b = dict(x=(1.0 + rng.standard_normal((B, *grid, 4, 2))).astype(f),
                 y=(1.0 + rng.standard_normal((B, *grid, 2, 2))).astype(f), msk=msk,
                 cls=rng.integers(0, 1 if family == "DPOT3D" else 2, B).astype(np.int32))
        if not family.startswith("UNet"):
            b["noise"] = rng.standard_normal((2, B, *grid, 4, 2)).astype(f)
        out.append(b)
    return out


def grab_grads():
    """Leaves the params alone and keeps the last gradient tree as its
    state: the JAX step's exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def jax_unet_step(apply, jvars, batch, mesh, accum):
    """The JAX package's UNet step on `mesh`'s data axis (grad_accum where
    the batch divides): its aux, and its gradients and batch statistics as
    a port state dict (gradients under the parameters' names)."""
    n = accum if batch["x"].shape[0] % accum == 0 else 1
    step = jax_train_step(noise_scale=0.0, donate=False, grad_accum=n)
    with mesh:
        st = replicate(JaxTrainState.create(apply, jvars, grab_grads(), jax.random.key(0)),
                       mesh)
        st, aux = step(st, shard_batch(batch, mesh))
    grads = dict(jax.device_get(st.opt_state).inner_state["params"])
    sd = state_dict_from_jax({"params": grads,
                              "batch_stats": jax.device_get(st.params)["batch_stats"]})
    return {k: float(np.reshape(v, ())) for k, v in aux.items() if k != "batch_stats"}, sd


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    refs = {}
    for seed, key in enumerate(("UNet_accum", "UNet_tail", "FNO", "DPOT3D", "CDPOT")):
        family = key.split("_")[0]
        jm, apply, jvars, sd = family_weights(family, CFGS[family])
        batches = family_batches(key, seed)
        torch.save(sd, tmp / f"{family}_sd.pt")
        torch.save([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
                   tmp / f"{key}_batches.pt")
        refs[key] = (jm, apply, jvars, sd, batches)
    wait = start("layout_step", tmp, dict(lr=1e-3, clip=0.5, noise=NOISE, layouts=[
        dict(name=name, model=key.split("_")[0], mesh=axes, shard_params=shard, accum=accum,
             cfg=CFGS[key.split("_")[0]], sd=str(tmp / f"{key.split('_')[0]}_sd.pt"),
             noise=NOISE * (accum == 1), batches=str(tmp / f"{key}_batches.pt"))
        for name, (key, axes, shard, accum) in LAYOUTS.items()]))
    try:
        want, one = {}, {}
        for key, (jm, apply, jvars, sd, batches) in refs.items():
            family = key.split("_")[0]
            accum = 2 if family == "UNet" else 1
            noise = NOISE * (accum == 1)
            mesh = jax_mesh(devices=jax.devices()[:2],
                            **(dict(data=2) if family == "UNet" else dict(data=1, model=2)))
            if family == "UNet":
                want[key] = jax_unet_step(apply, jvars, batches[0], mesh, accum)
            else:
                want[key] = jax_steps(jm, jvars, batches, mesh, place=jax_tp, apply=apply,
                                      noise=noise)
            one[key] = port_steps(CFGS[family], sd, batches, family, accum=accum, noise=noise)
    finally:
        ranks = wait()
        torch.set_num_threads(n)
    return ranks, want, one


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_family_layout_matches_jax_and_one_process(runs, name):
    """Each rank's steps against the JAX package's layout (2e-4; JAX keeps
    no BatchNorm counter) and one port process (the module docstring); TP
    shards only where JAX's rules reach (7 a trunk block)."""
    ranks, want, one = runs
    key, axes, shard, _ = LAYOUTS[name]
    family = key.split("_")[0]
    want_aux, want_params = want[key]
    ref = one[key]
    for r in ranks:
        got = r[name]
        assert len(got["tp_dims"]) == (7 * CFGS[family]["depth"]
                                       if family in ("DPOT3D", "CDPOT") else 0)
        assert got["sharded"] == (shard == "fsdp")
        if family != "UNet":
            assert_run(got, want_aux, want_params, JAX_TOL, f"jax {name}")
            assert_run(got, ref["aux"], ref["params"], ONE_TOL, f"one process {name}")
            continue
        (a,) = got["aux"]
        for k in ("loss_step", "loss_full", "grad_norm"):
            assert abs(a[k] - want_aux[k]) <= JAX_TOL * abs(want_aux[k]), ("jax", name, k)
            assert abs(a[k] - ref["aux"][0][k]) <= ONE_TOL * abs(ref["aux"][0][k]), (name, k)
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for k, g in ref["grads"].items():
            assert rel(got["grads"][k], g) <= GRAD_TOL, (name, k)
            assert rel(got["grads"][k], want_params[k]) <= GRAD_TOL, ("jax", name, k)
        for k, v in ref["params"].items():
            if "running_" in k or k.endswith("num_batches_tracked"):
                assert rel(got["params"][k], v) <= ONE_TOL, (name, k)
            if "running_" in k:
                assert rel(got["params"][k], want_params[k]) <= JAX_TOL, ("jax", name, k)


def test_batchnorm_statistics_are_the_global_batchs(runs):
    """UNet's running statistics over 2 ranks (DDP and FSDP2; the 8-row
    batch's two microbatches, or the 5-row tail that every rank holds
    whole) equal one process's, and they moved: the 18 BatchNorms' buffers
    are one application per microbatch and rollout step behind."""
    ranks, _, one = runs
    stats = [k for k in one["UNet_accum"]["params"] if k.endswith("running_var")]
    assert len(stats) == 18
    for r in ranks:
        for name, applications in (("unet_ddp_accum", 4), ("unet_ddp_tail", 2),
                                   ("unet_fsdp_accum", 4), ("unet_fsdp_tail", 2)):
            got = r[name]["params"]
            assert int(got["encoder1.enc1norm1.num_batches_tracked"]) == applications
            for k in stats:
                assert not torch.equal(got[k], torch.ones_like(got[k])), (name, k)


@pytest.mark.parametrize("family", ["DPOT3D", "CDPOT"])
def test_tp_rules_reach_the_trunk_blocks_as_jax_does(family):
    """The port's TP leaves of DPOT3D and CDPOT: 7 a trunk block, as many as
    the JAX package's name-keyed rules shard on the same weights."""
    jm, apply, jvars, sd = family_weights(family, CFGS[family])
    model = build_model(family, device="cpu", **CFGS[family])
    mesh = jax_mesh(data=1, model=2, devices=jax.devices()[:2])
    assert count_tp_leaves(model, 2) == jax_count_tp_leaves(jvars, mesh) \
        == 7 * CFGS[family]["depth"]


@pytest.mark.parametrize("family", ["DPOT3D", "CDPOT"])
def test_spatial_and_pipe_meshes_refused_as_jax_refuses_them(family):
    """JAX's DPOTNet3D and CDPOTNet take no spatial_mesh or pipe_mesh (the
    JAX loop passes them, and the model's construction raises TypeError);
    the port's check_ported refuses the same layouts."""
    from dpot_tpu.models import build_model as jax_build_model
    from dpot_tpu_torch.train.loop import check_ported
    from dpot_tpu_torch.utils.config import TrainConfig

    for kw, axis in (("spatial_mesh", "mesh_spatial"), ("pipe_mesh", "mesh_pipe")):
        with pytest.raises(TypeError, match=kw):
            jax_build_model(family, **CFGS[family], **{kw: None})
        with pytest.raises(ValueError, match="as in the JAX package"):
            check_ported(TrainConfig(model=family, train_paths=["x"], **{axis: 2}), world=2)
