"""The port's rollout server and serving CLI (dpot_tpu_torch/serve,
dpot_tpu_torch/cli/serve.py) on the CPU: the cases of tests/test_serve.py
that this slice carries, and the served rollout against the JAX server on the
same weights."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.serve import RolloutServer, serve, serve_multi


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test files at once, some of them timing host
    throughput; torch's CPU ops here keep to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KW = dict(img_size=16, patch_size=4, in_channels=2, in_timesteps=4, out_timesteps=1,
          embed_dim=32, depth=1, n_blocks=4, modes=4, n_cls=1)
SHAPE = (16, 16, 4, 2)


def small_model(dtype=torch.float32, seed=0, **kw):
    return build_model("DPOT", dtype=dtype, device="cpu", seed=seed, **{**KW, **kw})


def npy(x) -> bytes:
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def post(port, body, steps, query="", headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rollout?steps={steps}{query}", data=body,
        method="POST", headers=headers or {},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def get_json(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def direct_rollout(model, x, steps, wire=torch.float32):
    carry = torch.from_numpy(x).to(wire)
    outs = []
    with torch.no_grad():
        for _ in range(steps):
            im = model(carry)[0]
            outs.append(im)
            carry = torch.cat([carry[..., 1:, :], im.to(wire)], dim=-2)
    return torch.cat(outs, dim=-2).numpy()


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    model = small_model()
    httpd, rs = serve(model, port=0, batch_buckets=(1, 2, 4), max_wait_ms=30.0,
                      device="cpu")
    yield model, rs, httpd.server_address[1]
    httpd.shutdown()
    rs.stop(drain=True)
    httpd.server_close()


def test_healthz_and_rollout_matches_a_direct_loop(served):
    model, rs, port = served
    h = get_json(port, "/healthz")
    assert h["ok"] and h["model"] == "DPOTNet" and h["device"] == "cpu"
    assert h["wire_dtype"] == "float32" and h["response_dtype"] == "float32"
    x = rand((1, *SHAPE), 0)
    pred = post(port, npy(x), 3)
    assert pred.shape == (1, 16, 16, 3, 2) and pred.dtype == np.float32
    np.testing.assert_allclose(pred, direct_rollout(model, x, 3), atol=1e-6, rtol=0)


def test_served_rollout_matches_the_jax_server():
    """The same weights served by the JAX RolloutServer and by the port's,
    f32, steps = 3. Tolerance 2e-4 absolute, the interop bar, held over the
    three autoregressive steps."""
    import jax
    import jax.numpy as jnp

    from dpot_tpu.models import build_model as jax_build_model
    from dpot_tpu.serve import RolloutServer as JaxServer
    from dpot_tpu.train.interop import dpot_params_from_torch

    model = small_model(seed=5)
    params = dpot_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, depth=KW["depth"]
    )
    jm = jax_build_model("DPOT", dtype=jnp.float32, **KW)
    jax_rs = JaxServer(jm, jax.tree.map(jnp.asarray, params), batch_buckets=(1, 2),
                       max_wait_ms=1.0)
    rs = RolloutServer(model, batch_buckets=(1, 2), max_wait_ms=1.0, device="cpu")
    jax_rs.start()
    rs.start()
    try:
        x = rand((2, *SHAPE), 6)
        want = jax_rs.submit(x, 3)
        got = rs.submit(x, 3)
        assert got.shape == want.shape == (2, 16, 16, 3, 2)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    finally:
        jax_rs.stop(drain=True)
        rs.stop(drain=True)


def test_bf16_wire_exact():
    """wire_dtype='auto' ships bf16 requests for a bf16-compute model, and
    the results equal the f32 wire's bit for bit: the model's first op casts
    the input to bf16 either way. An f32 model keeps the f32 wire."""
    m16 = small_model(torch.bfloat16)
    auto = RolloutServer(m16, batch_buckets=(1, 2), max_wait_ms=1.0, device="cpu")
    f32 = RolloutServer(m16, batch_buckets=(1, 2), max_wait_ms=1.0,
                        wire_dtype="float32", device="cpu")
    assert auto.wire_dtype == "bfloat16" and auto.health()["wire_dtype"] == "bfloat16"
    assert f32.wire_dtype == "float32"
    auto.start()
    f32.start()
    try:
        x = rand((2, *SHAPE), 1)
        a = auto.submit(x, 3)
        b = f32.submit(x, 3)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        # an in-process caller may hand over bf16 as a CPU tensor
        c = auto.submit(torch.from_numpy(x).to(torch.bfloat16), 3)
        np.testing.assert_array_equal(a, c)
    finally:
        auto.stop(drain=True)
        f32.stop(drain=True)
    assert RolloutServer(small_model(), device="cpu").wire_dtype == "float32"
    with pytest.raises(ValueError):
        RolloutServer(small_model(), wire_dtype="float16", device="cpu")


def test_bf16_request_body_http(served):
    """A bf16 .npy body (numpy reads its descr as void-V2) gives what the
    same values give as float32."""
    _, _, port = served
    x = rand((1, *SHAPE), 3)
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    a = post(port, npy(bits.view("V2")), 3)
    b = post(port, npy(torch.from_numpy(x).to(torch.bfloat16).float().numpy()), 3)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_f16_response_wire():
    """response_dtype='float16' returns the fp16 rounding of the f32
    response (cast on the device after the rollout; the carry is untouched)."""
    m = small_model(torch.bfloat16)
    f32 = RolloutServer(m, batch_buckets=(1, 2), max_wait_ms=1.0, device="cpu")
    f16 = RolloutServer(m, batch_buckets=(1, 2), max_wait_ms=1.0,
                        response_dtype="float16", device="cpu")
    assert f16.health()["response_dtype"] == "float16"
    f32.start()
    f16.start()
    try:
        x = rand((2, *SHAPE), 2)
        a = f32.submit(x, 3)
        b = f16.submit(x, 3)
        assert a.dtype == np.float32 and b.dtype == np.float16
        np.testing.assert_array_equal(a.astype(np.float16), b)
    finally:
        f32.stop(drain=True)
        f16.stop(drain=True)
    with pytest.raises(ValueError):
        RolloutServer(m, response_dtype="bfloat16", device="cpu")


def test_microbatching_merges_concurrent_requests(served):
    model, rs, port = served
    before = rs.metrics()["batches"]
    xs = [rand((1, *SHAPE), 10 + i) for i in range(3)]
    results = [None] * 3

    def call(i):
        results[i] = post(port, npy(xs[i]), 1)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for x, r in zip(xs, results):
        np.testing.assert_allclose(r, direct_rollout(model, x, 1), atol=1e-5, rtol=0)
    assert rs.metrics()["batches"] - before < 3


def test_rejects_bad_rank_wrong_shape_and_empty_batch(served):
    """Only the batch dim may vary; a B=0 request has nothing to run."""
    _, rs, port = served
    seen = len(rs._seen_steps)
    for bad in (np.zeros((16, 16), np.float32), np.zeros((1, 8, 8, 4, 2), np.float32),
                np.zeros((1, 16, 16, 5, 2), np.float32), np.zeros((0, *SHAPE), np.float32)):
        with pytest.raises(urllib.error.HTTPError, match="400"):
            post(port, npy(bad), 1)
    assert len(rs._seen_steps) == seen


def test_oversize_request_chunks_through_buckets(served):
    model, rs, port = served
    x = rand((9, *SHAPE), 4)
    padded = rs.metrics()["padded_items"]
    pred = post(port, npy(x), 1)
    assert pred.shape == (9, 16, 16, 1, 2)
    np.testing.assert_allclose(pred, direct_rollout(model, x, 1), atol=1e-5, rtol=0)
    assert rs.metrics()["padded_items"] - padded == 3  # 9 = 4 + 4 + (1 padded to 4)


def test_metrics_endpoint(served):
    _, _, port = served
    post(port, npy(rand((1, *SHAPE), 5)), 1)
    m = get_json(port, "/metrics")
    assert m["requests"] >= 1 and m["batches"] >= 1 and m["latency_ms_avg"] > 0
    assert 0 < m["bucket_fill_rate"] <= 1 and m["accepting"] is True
    assert m["compiles"] == m["compiled_steps"] >= 1


def test_steps_validation(served):
    """Out-of-range steps are a 400; a new step count is counted once."""
    _, rs, port = served
    x = np.zeros((1, *SHAPE), np.float32)
    for bad in (0, -1, rs.max_steps + 1):
        with pytest.raises(urllib.error.HTTPError, match="400"):
            post(port, npy(x), bad)
    out = post(port, npy(x), 7, query="&foo=1")
    assert out.shape[-2] == 7
    after = rs.metrics()["compiles"]
    assert 7 in rs._seen_steps and after == len(rs._seen_steps)
    post(port, npy(x), 7)
    assert rs.metrics()["compiles"] == after


def test_auth_token():
    """/healthz stays open; /rollout and /metrics need the bearer token."""
    httpd, rs = serve(small_model(), port=0, auth_token="sekrit", batch_buckets=(1, 2),
                      max_wait_ms=5.0, device="cpu")
    port = httpd.server_address[1]
    try:
        assert get_json(port, "/healthz")["ok"]
        with pytest.raises(urllib.error.HTTPError, match="401"):
            get_json(port, "/metrics")
        body = npy(np.zeros((1, *SHAPE), np.float32))
        with pytest.raises(urllib.error.HTTPError, match="401"):
            post(port, body, 1, headers={"Authorization": "Bearer nope"})
        out = post(port, body, 1, headers={"Authorization": "Bearer sekrit"})
        assert out.shape == (1, 16, 16, 1, 2)
        assert rs.metrics()["auth_failures"] == 2
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()


def test_multi_model_routing():
    """?model=NAME routes to the named server, unnamed requests to the
    default, unknown names are a 404. The models differ in channel count,
    so a routing mistake shows in the shape."""
    models = {name: small_model(in_channels=c, seed=c) for name, c in (("a2", 2), ("b3", 3))}
    servers = {n: RolloutServer(m, batch_buckets=(1, 2), max_wait_ms=1.0, device="cpu")
               for n, m in models.items()}
    httpd, router = serve_multi(servers, default="b3", port=0)
    port = httpd.server_address[1]
    try:
        h = get_json(port, "/healthz")
        assert set(h["models"]) == {"a2", "b3"} and h["default"] == "b3"
        for name, c in (("a2", 2), ("b3", 3)):
            x = rand((1, 16, 16, 4, c), c)
            pred = post(port, npy(x), 1, query=f"&model={name}")
            assert pred.shape == (1, 16, 16, 1, c)
            np.testing.assert_allclose(pred, direct_rollout(models[name], x, 1), atol=1e-5, rtol=0)
        x = rand((1, 16, 16, 4, 3), 9)
        assert post(port, npy(x), 1).shape == (1, 16, 16, 1, 3)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            post(port, npy(x), 1, query="&model=nope")
        m = get_json(port, "/metrics")
        assert m["a2"]["requests"] >= 1 and m["b3"]["requests"] >= 2
    finally:
        httpd.shutdown()
        router.stop(drain=True)
        httpd.server_close()


def test_single_server_rejects_model_param(served):
    _, _, port = served
    with pytest.raises(urllib.error.HTTPError, match="404"):
        post(port, npy(np.zeros((1, *SHAPE), np.float32)), 1, query="&model=other")


def test_cpu_serving_never_launches_the_kernel(served):
    _, _, port = served
    before = fused_gn_afno.launches
    post(port, npy(rand((2, *SHAPE), 8)), 2)
    assert fused_gn_afno.launches == before


CLI_FLAGS = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "32",
             "--n_layers", "1", "--n_blocks", "4", "--modes", "4", "--T_in", "4",
             "--n_channels", "2", "--port", "0", "--device", "cpu"]


def test_cli_serves_seeded_and_pth_weights(tmp_path):
    """main(wait=False) serves a seeded model; --resume_path serves the
    weights of a reference-layout .pth; a directory without the model.pth
    of a port checkpoint is refused, naming what was expected."""
    from dpot_tpu_torch.cli.serve import main

    httpd, rs = main(CLI_FLAGS + ["--seed", "3", "--dtype", "bfloat16",
                                  "--response_dtype", "float16"], wait=False)
    try:
        port = httpd.server_address[1]
        h = get_json(port, "/healthz")
        assert h["wire_dtype"] == "bfloat16" and h["response_dtype"] == "float16"
        x = rand((1, *SHAPE), 0)
        pred = post(port, npy(x), 2)
        assert pred.dtype == np.float16 and pred.shape == (1, 16, 16, 2, 2)
        assert np.isfinite(pred).all()
        sd = rs.model.state_dict()
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()

    path = tmp_path / "w.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    httpd, rs = main(CLI_FLAGS + ["--seed", "9", "--dtype", "bfloat16",
                                  "--resume_path", str(path)], wait=False)
    try:
        for k, v in sd.items():
            assert torch.equal(rs.model.state_dict()[k], v)
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()

    with pytest.raises(FileNotFoundError, match="without model.pth"):
        main(CLI_FLAGS + ["--resume_path", str(tmp_path)], wait=False)


def test_cli_serves_the_checkpoint_directory_the_trainer_wrote(tmp_path):
    """cli.serve --resume_path <run>/model, the directory that cli.train
    writes, serves its weights: the answer equals a direct loop over the
    trained model."""
    from dpot_tpu_torch.cli.serve import main
    from dpot_tpu_torch.cli.train import main as train_main
    from dpot_tpu_torch.data.registry import make_synthetic_spec

    make_synthetic_spec("synthetic_tserve", train_size=4, test_size=2, t_total=8, t_test=2,
                        in_size=(16, 16), n_channels=2)
    arch = CLI_FLAGS[:CLI_FLAGS.index("--n_channels")]
    out = train_main(arch + ["--train_paths", "synthetic_tserve", "--batch_size", "4",
                             "--num_workers", "1", "--epochs", "1", "--warmup_epochs", "1",
                             "--use_writer", "true", "--log_path", str(tmp_path),
                             "--device", "cpu"])
    httpd, rs = main(CLI_FLAGS + ["--resume_path", f"{out['log_dir']}/model"], wait=False)
    try:
        for k, v in out["model"].state_dict().items():
            assert torch.equal(rs.model.state_dict()[k], v), k
        x = rand((2, *SHAPE), 5)
        pred = post(httpd.server_address[1], npy(x), 2)
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()
    carry, want = torch.from_numpy(x), []
    with torch.inference_mode():
        for _ in range(2):
            im = out["model"].eval()(carry)[0]
            want.append(im)
            carry = torch.cat([carry[..., 1:, :], im], dim=-2)
    np.testing.assert_array_equal(pred, torch.cat(want, dim=-2).numpy())


def test_cli_serve_loads_a_pth_as_evaluate_does(tmp_path):
    """serve and evaluate share one loader: a .pth written at res 16 (4x4
    latent) serves at res 32, its pos_embed resized to the 8x8 latent as
    params_from_any resizes it, every other weight as saved."""
    from dpot_tpu_torch.cli.serve import main
    from dpot_tpu_torch.train.interop import resize_pos_embed

    sd = small_model(seed=4).state_dict()
    path = tmp_path / "w.pth"
    torch.save({"model": sd}, path)
    flags = list(CLI_FLAGS)
    flags[flags.index("--res") + 1] = "32"
    httpd, rs = main(flags + ["--resume_path", str(path)], wait=False)
    try:
        got = rs.model.state_dict()
        pred = post(httpd.server_address[1], npy(rand((1, 32, 32, 4, 2), 6)), 1)
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()
    assert got["pos_embed"].shape == (1, 32, 8, 8)
    torch.testing.assert_close(got["pos_embed"], resize_pos_embed(sd["pos_embed"], 8, 8),
                               rtol=0, atol=0)
    for k, v in sd.items():
        if k != "pos_embed":
            assert torch.equal(got[k], v), k
    assert pred.shape == (1, 32, 32, 1, 2) and np.isfinite(pred).all()


def test_cli_multi_model_yaml(tmp_path):
    from dpot_tpu_torch.cli.serve import main

    fleet = tmp_path / "fleet.yaml"
    fleet.write_text(
        "default: b\nmodels:\n"
        "  a: {res: 16, patch_size: 4, width: 32, n_layers: 1, modes: 4, T_in: 4, n_channels: 2}\n"
        "  b: {res: 16, patch_size: 4, width: 32, n_layers: 1, modes: 4, T_in: 4, n_channels: 3}\n"
    )
    httpd, router = main(["--models", str(fleet), "--port", "0", "--device", "cpu"], wait=False)
    try:
        port = httpd.server_address[1]
        assert post(port, npy(rand((1, 16, 16, 4, 2), 1)), 1, query="&model=a").shape[-1] == 2
        assert post(port, npy(rand((1, 16, 16, 4, 3), 2)), 1).shape[-1] == 3
    finally:
        httpd.shutdown()
        router.stop(drain=True)
        httpd.server_close()
    bad = tmp_path / "bad.yaml"
    bad.write_text("models:\n  a: {widht: 3}\n")
    with pytest.raises(SystemExit):
        main(["--models", str(bad), "--device", "cpu"], wait=False)


def test_config_flags_and_yaml(tmp_path):
    from dpot_tpu_torch.utils.config import TrainConfig, load_config

    cfg = load_config(["--width", "64", "--normalize", "true", "--train_paths", "a", "b"])
    assert cfg.width == 64 and cfg.normalize is True and cfg.test_paths == ["a", "b"]
    assert cfg.data_weights == [1, 1]
    y = tmp_path / "c.yaml"
    y.write_text("width: 128\nmodes: 8\nunknown_key: 1\n")
    cfg = load_config(["--config_file", str(y), "--modes", "16"])
    assert (cfg.width, cfg.modes) == (128, 16)
    with pytest.raises(ValueError):
        TrainConfig(batch_size=3, grad_accum=2)
