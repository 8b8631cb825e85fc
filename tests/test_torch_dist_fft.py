"""The port's spatial sharding (dpot_tpu_torch/parallel/dist_fft.py, the
pencil-decomposed AFNO mixer, and DPOTNet over a 'spatial' axis) on gloo
ranks on the CPU, held against the port's single-device route and against
the JAX package's `afno_filter_2d_sharded` and spatially sharded DPOTNet.

Two launches (tests/torch_dist_cases.py, each under a 120 s limit): two
ranks (spatial = 2) for the mixer at modes 5 and 32 on a 32 x 32 grid
(17 W-frequencies, padded to 18 over the 2 ranks), its gradient, its bf16
wire, and a model step; four ranks (data 2 x spatial 2) for the model's
forward and train steps. f32: within 2e-4 of JAX's and 1e-5 of one port
process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch_dist_cases import launch
from torch_layout_ref import (JAX_TOL, ONE_TOL, assert_run, jax_steps, make_batches,
                              port_steps, rel, save_inputs, seeded_weights)

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.ops.activations import get_activation as jax_activation
from dpot_tpu.parallel.dist_fft import afno_filter_2d_sharded as jax_sharded
from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.spectral import afno_filter_2d

pytestmark = pytest.mark.multichip

CFG = dict(img_size=32, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
MIXER_CASES = [(5, "float32"), (32, "float32"), (12, "bfloat16")]


def mixer_inputs(B=2, H=32, W=32, C=16, nb=4, seed=0):
    rng = np.random.default_rng(seed)
    bs = C // nb
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    ws = [(rng.random(s) * (1.0 / (bs * bs))).astype(np.float32)
          for s in [(2, nb, bs, bs), (2, nb, bs), (2, nb, bs, bs), (2, nb, bs)]]
    r = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, ws, r


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    x, ws, r = mixer_inputs()
    torch.save({"x": torch.from_numpy(x), "weights": [torch.from_numpy(w) for w in ws],
                "r": torch.from_numpy(r)}, tmp / "mixer.pt")
    jvars, sd = seeded_weights(CFG)
    batches = make_batches(2, grid=32)
    common = dict(save_inputs(tmp, sd, batches), cfg=CFG)
    suite = [("mixer", "mixer", dict(inputs=str(tmp / "mixer.pt"), cases=MIXER_CASES)),
             ("step", "layout_step", dict(common, layouts=[
                 dict(name="sp", mesh=dict(spatial=2))]))]
    ranks = launch("suite", tmp, dict(suite=suite))
    yield dict(mixer=(x, ws, r), ranks=ranks, jvars=jvars, batches=batches, common=common,
               one=port_steps(CFG, sd, batches))
    torch.set_num_threads(n)


def gathered_rows(ranks, key, what):
    return torch.cat([r["mixer"][key][what] for r in ranks], dim=1)


@pytest.mark.parametrize("modes", [5, 32])
def test_sharded_mixer_matches_jax_and_the_single_device_route(setup, modes):
    """The two ranks' rows of the pencil-FFT mixer: within 1e-5 of the
    port's single-device afno_filter_2d and 2e-4 of JAX's
    afno_filter_2d_sharded over spatial = 2 (odd W-frequencies padded)."""
    x, ws, _ = setup["mixer"]
    got = gathered_rows(setup["ranks"], f"{modes}/float32", "y")
    act = get_activation("gelu")
    one = afno_filter_2d(torch.from_numpy(x), *map(torch.from_numpy, ws), modes, act)
    assert rel(got, one) <= ONE_TOL
    mesh = jax_mesh(data=1, spatial=2, devices=jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "spatial", None, None)))
    want = jax_sharded(xs, *map(jnp.asarray, ws), modes, jax_activation("gelu"), mesh=mesh)
    assert rel(got, np.asarray(want)) <= JAX_TOL


def test_sharded_mixer_gradient_matches_the_single_device_route(setup):
    """d sum(y * r) / d(x, weights) through the two all-to-alls (each its own
    adjoint): the ranks' x rows and the sum of their weight gradients
    within 1e-5 of autograd through the single-device route."""
    x, ws, r = setup["mixer"]
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    y = afno_filter_2d(xt, *wt, 5, get_activation("gelu"))
    (y * torch.from_numpy(r)).sum().backward()
    assert rel(gathered_rows(setup["ranks"], "5/float32", "dx"), xt.grad) <= ONE_TOL
    for i, w in enumerate(wt):
        got = sum(rk["mixer"]["5/float32"]["dw"][i] for rk in setup["ranks"])
        assert rel(got, w.grad) <= ONE_TOL, i


def test_bf16_wire_stays_within_bf16_of_f32(setup):
    """compute_dtype bf16 (bf16 through both transposes and in the mode MLP,
    the transforms in f32): within 5e-4 of the f32 route, JAX's own bar."""
    x, ws, _ = setup["mixer"]
    got = gathered_rows(setup["ranks"], "12/bfloat16", "y")
    want = afno_filter_2d(torch.from_numpy(x), *map(torch.from_numpy, ws), 12,
                          get_activation("gelu"))
    assert got.dtype == torch.float32
    assert 0 < rel(got, want) < 5e-4


def jax_spatial_steps(setup, mesh):
    jm = jax_build_model("DPOT", spatial_mesh=mesh, **CFG)
    return jax_steps(jm, setup["jvars"], setup["batches"], mesh, spatial=True)


def test_two_rank_spatial_model_matches_jax_and_one_process(setup):
    """DPOTNet over spatial = 2 (each rank its 16 rows of the 32^2 grid, the
    norms, instance statistics, classifier mean and loss summed over the
    axis): the forward's rows within 1e-5 of one process's, two adam steps
    within 2e-4 of JAX's spatially sharded steps and 1e-5 of one port
    process; no fused-kernel call (the mixer is the pencil FFT)."""
    pred, cls = setup["one"]["forward"]
    got_pred = torch.cat([r["step"]["sp"]["forward"][0] for r in setup["ranks"]], dim=1)
    assert rel(got_pred, pred) <= ONE_TOL
    for r in setup["ranks"]:
        assert rel(r["step"]["sp"]["forward"][1], cls) <= ONE_TOL
    want_aux, want = jax_spatial_steps(setup, jax_mesh(data=1, spatial=2,
                                                       devices=jax.devices()[:2]))
    for r in setup["ranks"]:
        got = r["step"]["sp"]
        assert_run(got, want_aux, want, JAX_TOL, "jax")
        assert_run(got, setup["one"]["aux"], setup["one"]["params"], ONE_TOL, "one process")
        assert got["calls"] == 0


def test_data_by_spatial_model_matches_jax_and_one_process(setup, tmp_path):
    """data 2 x spatial 2 on 4 ranks: the forward and two adam steps against
    JAX's make_mesh(data=2, spatial=2) steps within 2e-4 and one port
    process within 1e-5."""
    ranks = launch("layout_step", tmp_path, dict(setup["common"], layouts=[
        dict(name="dp_sp", mesh=dict(data=2, spatial=2))]), world=4)
    pred, _ = setup["one"]["forward"]
    # rank = data * 2 + spatial: data 0 holds rows 0..3 of the batch
    got_pred = torch.cat([ranks[0]["dp_sp"]["forward"][0], ranks[1]["dp_sp"]["forward"][0]],
                         dim=1)
    assert rel(got_pred, pred[:4]) <= ONE_TOL
    want_aux, want = jax_spatial_steps(setup, jax_mesh(data=2, spatial=2,
                                                       devices=jax.devices()[:4]))
    for r in ranks:
        got = r["dp_sp"]
        assert got["world"] == 2
        assert_run(got, want_aux, want, JAX_TOL, "jax")
        assert_run(got, setup["one"]["aux"], setup["one"]["params"], ONE_TOL, "one process")
