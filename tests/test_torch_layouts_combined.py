"""The port's layouts combined (dpot_tpu_torch/train/loop.py place_state) on
4 gloo ranks on the CPU: FSDP2 over 'data' with the GPipe pipeline (JAX's
tests/test_pipeline.py:149), TP with the pipeline, TP with spatial
sharding, FSDP2 with spatial sharding and with a replicated 'model' axis,
and tp_fsdp with the pipeline and with spatial sharding (FSDP2 over a
data axis of one rank: the composition, not the memory).

One launch (tests/torch_dist_cases.py, under a 120 s limit), started before
the references so that the ranks run while the JAX package's steps
compile. The tiny DPOT of test_torch_tp.py (width 32, 4 AFNO blocks, depth
2, 16^2 grid) in f32, two adam steps with the clip active and external
noise: every rank's losses, grad norms and gathered weights within 1e-5 of
one port process and within 2e-4 of the JAX package's layout of the same
global step (its fsdp+pipe, tp+pipe and tp+spatial meshes; the JAX package
runs every combination here, and each computes one function, so the fsdp
and tp_fsdp variants are held to the JAX layout of their other axis)."""

import jax
import pytest
import torch
from torch_dist_cases import start
from torch_layout_ref import (JAX_TOL, ONE_TOL, assert_run, jax_steps, make_batches,
                              port_steps, save_inputs, seeded_weights)

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.parallel.fsdp import shard_state_fsdp as jax_fsdp
from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu.parallel.tensor import shard_state_tp as jax_tp

pytestmark = pytest.mark.multichip

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
# name: (mesh axes, shard_params, the JAX layout it is held to)
LAYOUTS = {
    "fsdp_pipe": (dict(data=2, pipe=2), "fsdp", "fsdp_pipe"),
    "tp_pipe": (dict(model=2, pipe=2), "tp", "tp_pipe"),
    "tp_spatial": (dict(model=2, spatial=2), "tp", "tp_spatial"),
    "fsdp_spatial": (dict(data=2, spatial=2), "fsdp", "tp_spatial"),
    "fsdp_model": (dict(data=2, model=2), "fsdp", "tp_pipe"),
    "tp_fsdp_pipe": (dict(data=1, model=2, pipe=2), "tp_fsdp", "tp_pipe"),
    "tp_fsdp_spatial": (dict(data=1, model=2, spatial=2), "tp_fsdp", "tp_spatial"),
}
# the JAX package's layouts: mesh axes, placement, the model's meshes
JAX_LAYOUTS = {
    "fsdp_pipe": (dict(data=2, pipe=2), lambda st, m: jax_fsdp(st, m, min_size=0), "pipe"),
    "tp_pipe": (dict(data=1, model=2, pipe=2), jax_tp, "pipe"),
    "tp_spatial": (dict(data=1, model=2, spatial=2), jax_tp, "spatial"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("combined")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jvars, sd = seeded_weights(CFG)
    batches = make_batches(2)
    wait = start("layout_step", tmp, dict(save_inputs(tmp, sd, batches), cfg=CFG, layouts=[
        dict(name=name, mesh=axes, shard_params=shard, micro=2)
        for name, (axes, shard, _) in LAYOUTS.items()]), world=4)
    try:
        want = {}
        for name, (axes, place, model_mesh) in JAX_LAYOUTS.items():
            mesh = jax_mesh(devices=jax.devices()[:4], **axes)
            jm = jax_build_model("DPOT", **CFG, **{f"{model_mesh}_mesh": mesh})
            want[name] = jax_steps(jm, jvars, batches, mesh, place=place,
                                   spatial=model_mesh == "spatial")
        one = port_steps(CFG, sd, batches)
    finally:
        ranks = wait()
        torch.set_num_threads(n)
    return ranks, want, one


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_combined_layout_matches_jax_and_one_process(runs, name):
    """Each rank's two steps in the layout: within 2e-4 of the JAX
    package's layout and 1e-5 of one port process; TP shards and pipeline
    stages where the layout makes them, FSDP2's DTensors where it shards."""
    ranks, want, one = runs
    axes, shard, jax_name = LAYOUTS[name]
    want_aux, want_params = want[jax_name]
    assert want_aux[0]["grad_norm"] > 0.5  # the clip is active
    for r in ranks:
        got = r[name]
        assert got["world"] == axes.get("data", 1)
        assert got["sharded"] == (shard in ("fsdp", "tp_fsdp"))
        assert bool(got["tp_dims"]) == shard.startswith("tp")
        blocks = {n.split(".")[1] for n in got["local_shapes"] if n.startswith("blocks.")}
        assert len(blocks) == CFG["depth"] // axes.get("pipe", 1)
        assert_run(got, want_aux, want_params, JAX_TOL, f"jax {name}")
        assert_run(got, one["aux"], one["params"], ONE_TOL, f"one process {name}")
