"""Serving CLI of the port: build model(s) and serve autoregressive rollouts
(port of dpot_tpu/cli/serve.py).

Single model, weights drawn from --seed or loaded from a reference-layout
.pth or a checkpoint directory that the port's trainer wrote:

    python -m dpot_tpu_torch.cli.serve --model DPOT --res 128 --width 512 \
        --n_layers 4 [--resume_path dpot_ti.pth] [--dtype bfloat16] --port 8476

Multi-model (one process, one device, N models; requests route by
`?model=name`):

    python -m dpot_tpu_torch.cli.serve --models fleet.yaml --port 8476

where fleet.yaml maps `models:` names to TrainConfig fields and may name a
`default:` (see dpot_tpu/cli/serve.py). --device picks the device (cuda by
default; cpu runs the kernels' plain versions). Endpoints: GET /healthz,
GET /metrics, POST /rollout?steps=N[&model=NAME] (dpot_tpu_torch/serve).
"""

from __future__ import annotations

import dataclasses
import sys

import torch


def _build_served(cfg, device: str):
    """The served model for one TrainConfig: seeded weights, or those at
    cfg.resume_path (a reference-layout .pth, or a checkpoint directory that
    the port wrote or its model.pth)."""
    from dpot_tpu_torch.models import build_model

    model = build_model(
        cfg.model, img_size=cfg.res, patch_size=cfg.patch_size,
        in_channels=cfg.n_channels, in_timesteps=cfg.T_in,
        out_timesteps=cfg.T_bundle, embed_dim=cfg.width, modes=cfg.modes,
        depth=cfg.n_layers, n_blocks=cfg.n_blocks, mlp_ratio=cfg.mlp_ratio,
        out_layer_dim=cfg.out_layer_dim, n_cls=len(cfg.train_paths),
        act=cfg.act, normalize=cfg.normalize, use_ln=cfg.use_ln,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        device=device, seed=cfg.seed,
    )
    if cfg.resume_path:
        from dpot_tpu_torch.train.interop import params_from_any

        model.load_state_dict(params_from_any(cfg.resume_path, model), strict=True)
    return model


def main(argv=None, wait=True):
    """wait=False returns (httpd, server) instead of blocking until SIGTERM:
    the in-process hook for tests and chip_smoke.py."""
    from dpot_tpu_torch.utils.config import TrainConfig, load_config, pop_flag

    argv = list(argv if argv is not None else sys.argv[1:])
    host = pop_flag(argv, "--host", "127.0.0.1")
    port = pop_flag(argv, "--port", 8476, int)
    auth_token = pop_flag(argv, "--auth_token", None)
    max_steps = pop_flag(argv, "--max_steps", 64, int)
    ssl_certfile = pop_flag(argv, "--ssl_certfile", None)
    ssl_keyfile = pop_flag(argv, "--ssl_keyfile", None)
    wire_dtype = pop_flag(argv, "--wire_dtype", "auto")
    response_dtype = pop_flag(argv, "--response_dtype", "float32")
    device = pop_flag(argv, "--device", "cuda")
    models_yaml = pop_flag(argv, "--models", None)
    server_kw = dict(max_steps=max_steps, wire_dtype=wire_dtype,
                     response_dtype=response_dtype, device=device)

    if models_yaml:
        import yaml

        from dpot_tpu_torch.serve import RolloutServer, serve_multi

        if argv:
            raise SystemExit(
                "--models mode takes its per-model config from the YAML; "
                f"unexpected extra CLI flags: {argv}"
            )
        with open(models_yaml) as f:
            spec = yaml.safe_load(f)
        if not isinstance(spec, dict) or not isinstance(spec.get("models"), dict) \
                or not spec["models"]:
            raise SystemExit(
                f"fleet YAML {models_yaml!r} must contain a non-empty 'models:' mapping"
            )
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        servers = {}
        for name, entry in spec["models"].items():
            unknown = set(entry) - fields
            if unknown:
                raise SystemExit(
                    f"model {name!r}: unknown config keys {sorted(unknown)} "
                    "(misspelled TrainConfig field?)"
                )
            cfg = TrainConfig(**entry)
            servers[name] = RolloutServer(
                _build_served(cfg, device), t_bundle=cfg.T_bundle, **server_kw
            )
        httpd, rs = serve_multi(
            servers, default=spec.get("default"), auth_token=auth_token,
            host=host, port=port, ssl_certfile=ssl_certfile, ssl_keyfile=ssl_keyfile,
        )
        desc = f"{len(servers)} models ({', '.join(sorted(servers))}; default={rs.default})"
    else:
        from dpot_tpu_torch.serve import serve

        cfg = load_config(argv)
        httpd, rs = serve(
            _build_served(cfg, device), host=host, port=port,
            t_bundle=cfg.T_bundle, auth_token=auth_token,
            ssl_certfile=ssl_certfile, ssl_keyfile=ssl_keyfile, **server_kw,
        )
        desc = f"{cfg.model} ({rs.n_params / 1e6:.1f}M params, {rs.device})"

    scheme = "https" if ssl_certfile else "http"
    print(f"serving {desc} on {scheme}://{host}:{httpd.server_address[1]}"
          + (" [auth required]" if auth_token else ""), flush=True)

    if not wait:
        return httpd, rs

    import signal
    import threading

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    # graceful: stop accepting, finish queued work, then close the listener
    print("shutting down (draining queue)...", flush=True)
    rs.stop(drain=True)
    httpd.shutdown()


if __name__ == "__main__":
    main()
