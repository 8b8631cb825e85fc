"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its results as JSON lines:
  1. device and build: the card's name and power limit (nvidia-smi), then the
     nvcc build of every kernel in dpot_tpu_torch/csrc;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes of DPOT-Ti serving (B in {1, 8}, bf16 with
     tanh-GELU and f32 with erf-GELU), with its CUDA-event time, the device
     time of each of its launches (torch.profiler), the plain version's time
     and the least time the card could take (its bound);
  3. serve: `python -m dpot_tpu_torch.cli.serve` in-process at DPOT-Ti full
     width and depth (seeded weights), bf16 and then f32 compute, each
     answering rollout requests over HTTP on 127.0.0.1; every served
     rollout is checked for shape and finite values, one against a direct
     loop over model(x), the kernel's launch count against depth x model
     applications, and the served model's forward on the card against the
     same weights' forward on the CPU (the plain versions there);
  4. step: where one model application's time goes at B = 1 and 8 (wall
     time, device busy time and idle share, the fused kernel's part).
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": ...}.
float32 matrix products run in full float32 (TF32 off, set below).
Any failure raises, so the script exits non-zero and prints no result. It
needs one CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import copy
import io
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from dpot_tpu_torch.ops.cuda import build
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno, fused_gn_afno_ref
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# DPOT-Ti serving geometry: 128^2 grid, patch 8 -> 16x16 latent, modes 32
TI = dict(H=16, W=16, C=512, nb=4, modes=32, groups=8, depth=4)
TI_FLAGS = [
    "--model", "DPOT", "--res", "128", "--patch_size", "8", "--width", "512",
    "--n_layers", "4", "--n_blocks", "4", "--modes", "32", "--mlp_ratio", "1",
    "--out_layer_dim", "32", "--T_in", "10", "--n_channels", "4",
    "--host", "127.0.0.1", "--port", "0",
]
# kernel vs plain version: f32 differs by summation order only; bf16 may
# differ where one rounding of z, h or o to bf16 falls the other way
TOL = {
    torch.float32: dict(max_abs=5e-5, rel_l2=1e-5),
    torch.bfloat16: dict(max_abs_ulps=4, rel_l2=4e-3),
}
BF16_EPS = 2.0 ** -7
# whole forward, card against CPU on the same weights: f32 differs by
# summation order through ~20 layers; bf16 by a few bf16 roundings per layer
CPU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median over `runs` of one call's CUDA-event time, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SUB_KERNELS = ("gn_stats_kernel", "analysis_kernel", "mode_hidden_kernel",
               "mode_out_kernel", "synthesis_kernel")


def kernel_us(fn, runs: int) -> dict[str, float]:
    """Device time in µs, summed over `runs` calls of fn, of each CUDA kernel
    that fn launched, by name, from torch.profiler. The profiler now and
    then returns no device activity; it is then asked again, up to three
    times, and an empty result means that the time was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
        if times:
            return times
    return {}


def device_ms(fn, runs: int = 20) -> dict | None:
    """Device time per call of each of the wrapper's launches, in ms (None:
    not measured)."""
    fn()
    torch.cuda.synchronize()
    times = kernel_us(fn, runs)
    if not times:
        return None
    out = {k: sum(v for name, v in times.items() if k in name) / runs / 1e3
           for k in SUB_KERNELS}
    out["total"] = sum(out.values())
    return out


def afno_case(B: int, dtype: torch.dtype, weight_scale: float | None, seed: int):
    """Seeded kernel arguments at the Ti geometry. weight_scale None draws
    the AFNO weights as the init does, scale * U[0, 1) with scale 1/bs^2;
    a number draws them from N(0, weight_scale^2) so the mode MLP matters."""
    H, W, C, nb, groups = TI["H"], TI["W"], TI["C"], TI["nb"], TI["groups"]
    bs = C // nb
    kh, kw = kept_modes(H, W, TI["modes"])
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    def w(shape):
        if weight_scale is None:
            return rng.random(shape) / (bs * bs)
        return rng.standard_normal(shape) * weight_scale

    A, Ainv = combined_spectral_ops(H, W, kh, kw, dtype, torch.device("cuda"))
    args = (
        t(rng.standard_normal((B, H * W, C)), dtype),
        t(1.0 + 0.1 * rng.standard_normal(C)),
        t(0.1 * rng.standard_normal(C)),
        A, Ainv,
        t(w((2, nb, bs, bs))), t(w((2, nb, bs))),
        t(w((2, nb, bs, bs))), t(w((2, nb, bs))),
    )
    return args, kh * kw, groups


def afno_bound_ms(B: int, dtype: torch.dtype, K: int) -> tuple[float, str]:
    """Least time for one call: operations over the peak for the operand
    type, or bytes (each input read once, the output written once) over
    HBM bandwidth, whichever is larger."""
    HW, C, nb = TI["H"] * TI["W"], TI["C"], TI["nb"]
    bs = C // nb
    s = torch.empty((), dtype=dtype).element_size()
    flops = B * (2 * 2 * K * HW * C            # analysis A . xn
                 + 2 * 2 * K * (2 * bs) ** 2 * nb  # two MLP layers
                 + 2 * HW * 2 * K * C)          # synthesis Ainv . o
    nbytes = (2 * B * HW * C * s               # x in, out
              + 2 * 2 * K * HW * s             # A, Ainv
              + 2 * (2 * nb * bs * bs + 2 * nb * bs) * 4  # w1, b1, w2, b2
              + 2 * C * 4)                     # gscale, gbias
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_afno(B, dtype, weight_scale, seed) -> dict:
    args, K, groups = afno_case(B, dtype, weight_scale, seed)
    approx = dtype == torch.bfloat16
    got = fused_gn_afno(*args, K, groups, approx).float()
    want = fused_gn_afno_ref(*args, K, groups, approx).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"fused_gn_afno B={B} {dtype}: non-finite output")
    max_abs = (got - want).abs().max().item()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    tol = TOL[dtype]
    lim = tol.get("max_abs") or tol["max_abs_ulps"] * BF16_EPS * want.abs().max().item()
    if max_abs > lim or rel_l2 > tol["rel_l2"]:
        raise AssertionError(
            f"fused_gn_afno B={B} {dtype} scale={weight_scale}: max_abs {max_abs} "
            f"(limit {lim}), rel_l2 {rel_l2} (limit {tol['rel_l2']})"
        )
    return dict(args=args, K=K, groups=groups, approx=approx,
                max_abs_err=max_abs, rel_l2=rel_l2, max_abs_limit=lim)


def phase_kernels() -> dict:
    """fused_gn_afno against its plain version; returns per-config numbers."""
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            check_afno(B, dtype, 0.05, seed=100 + B)  # MLP-dominated weights
            r = check_afno(B, dtype, None, seed=B)     # the init's scale
            a, K, g, ap = r["args"], r["K"], r["groups"], r["approx"]
            ms = cuda_ms(lambda: fused_gn_afno(*a, K, g, ap))
            plain_ms = cuda_ms(lambda: fused_gn_afno_ref(*a, K, g, ap))
            dev = device_ms(lambda: fused_gn_afno(*a, K, g, ap))
            bound, by = afno_bound_ms(B, dtype, K)
            key = f"{str(dtype).replace('torch.', '')}/B{B}"
            results[key] = dict(
                max_abs_err=r["max_abs_err"], rel_l2=r["rel_l2"],
                max_abs_limit=r["max_abs_limit"], ms=ms, plain_ms=plain_ms,
                device_ms=dev, bound_ms=bound, bound_by=by,
            )
            log("kernel", name="fused_gn_afno", config=key, **results[key])
    return results


def post_rollout(port: int, body: bytes, steps: int) -> tuple[np.ndarray, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/rollout?steps={steps}", data=body, method="POST"
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = np.load(io.BytesIO(r.read()))
    return out, (time.perf_counter() - t0) * 1e3


def npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def bf16_npy(x: np.ndarray) -> bytes:
    """A bfloat16 .npy body without ml_dtypes: the raw 16-bit words, saved
    as void-V2 (the descr numpy gives a bfloat16 array it cannot name)."""
    bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    return npy(bits.view("V2"))


def direct_rollout(model, x: np.ndarray, steps: int, wire: torch.dtype) -> torch.Tensor:
    carry = torch.from_numpy(x).to("cuda").to(wire)
    outs = []
    with torch.inference_mode():
        for _ in range(steps):
            im = model(carry)[0]
            outs.append(im)
            carry = torch.cat([carry[..., 1:, :], im.to(wire)], dim=-2)
    return torch.cat(outs, dim=-2).float()


def card_vs_cpu_forward(model, x: np.ndarray) -> float:
    """Relative L2 distance between the model's forward on the card (the
    CUDA kernel) and a copy of it on the CPU (the plain versions)."""
    cpu = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        want = cpu(torch.from_numpy(x))[0]
        got = model(torch.from_numpy(x).to("cuda"))[0].cpu()
    return ((got - want).norm() / want.norm()).item()


def phase_serve(dtype: str, response_dtype: str) -> dict:
    """Serve DPOT-Ti through the CLI and check every answer."""
    from dpot_tpu_torch.cli.serve import main as serve_main

    fused_gn_afno.launches = 0
    httpd, rs = serve_main(
        TI_FLAGS + ["--dtype", dtype, "--response_dtype", response_dtype,
                    "--device", "cuda"],
        wait=False,
    )
    try:
        port = httpd.server_address[1]
        applications = len(rs._warmup_steps)  # one max-bucket batch per step count
        rng = np.random.default_rng(7)
        lat = []
        kept = None
        for B in (1, 2, 4):
            for steps in (1, 4):
                x = rng.standard_normal((B, 128, 128, 10, 4)).astype(np.float32)
                for body in (npy(x), bf16_npy(x)):
                    pred, ms = post_rollout(port, body, steps)
                    applications += steps
                    lat.append(ms)
                    if pred.shape != (B, 128, 128, steps, 4):
                        raise AssertionError(f"served shape {pred.shape}")
                    if pred.dtype != np.dtype(response_dtype):
                        raise AssertionError(f"served dtype {pred.dtype}")
                    if not np.isfinite(pred).all():
                        raise AssertionError("served rollout has non-finite values")
                    if B == 1 and steps == 4 and kept is None:
                        kept = (x, pred)
        torch.cuda.synchronize()
        launches = fused_gn_afno.launches
        want_launches = TI["depth"] * applications
        if launches != want_launches:
            raise AssertionError(
                f"fused_gn_afno launched {launches} times, expected depth x "
                f"applications = {want_launches}"
            )
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        # the same request, replayed as a direct loop over model(x)
        x, pred = kept
        wire = torch.bfloat16 if rs.wire_dtype == "bfloat16" else torch.float32
        ref = direct_rollout(rs.model, x, 4, wire).to(getattr(torch, response_dtype))
        ref = ref.float().cpu()
        got = torch.from_numpy(pred.astype(np.float32))
        rel = ((got - ref).norm() / ref.norm()).item()
        if rel > 1e-5:
            raise AssertionError(f"served rollout differs from a direct loop: rel_l2 {rel}")
        cpu_rel = card_vs_cpu_forward(rs.model, x)
        if cpu_rel > CPU_TOL[dtype]:
            raise AssertionError(
                f"{dtype} forward on the card differs from the CPU's: rel_l2 {cpu_rel} "
                f"(limit {CPU_TOL[dtype]})"
            )
        out = dict(
            dtype=dtype, response_dtype=response_dtype, requests=len(lat),
            applications=applications, launches=launches,
            client_p50_ms=statistics.median(lat), client_ms=lat,
            direct_loop_rel_l2=rel, card_vs_cpu_rel_l2=cpu_rel,
            card_vs_cpu_limit=CPU_TOL[dtype], metrics=metrics,
        )
        log("serve", **out)
        return out
    finally:
        rs.stop(drain=True)
        httpd.shutdown()
        httpd.server_close()


def phase_step(dtype: str, runs: int = 10) -> list[dict]:
    """Where one rollout step's time goes: one Ti model application at
    B = 1 and B = 8 on the card. Wall time on the host clock (synchronised),
    device busy time and the fused kernel's part of it from torch.profiler;
    the device is idle for the rest of the wall time."""
    from dpot_tpu_torch.models import build_model

    model = build_model(
        "DPOT", preset="Ti", img_size=128, patch_size=8, in_channels=4,
        in_timesteps=10, n_cls=1, dtype=getattr(torch, dtype), device="cuda", seed=0,
    ).eval()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for B in (1, 8):
        x = torch.randn((B, 128, 128, 10, 4), generator=gen, device="cuda")
        with torch.inference_mode():
            def step():
                return model(x)

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(runs):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / runs * 1e3
            times = kernel_us(step, runs)
        row = dict(dtype=dtype, batch=B, wall_ms=wall)
        if times:
            busy = sum(times.values()) / runs / 1e3
            fused = sum(v for k, v in times.items()
                        if any(s in k for s in SUB_KERNELS)) / runs / 1e3
            top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
            row.update(device_busy_ms=busy, device_idle_share=1 - busy / wall,
                       fused_gn_afno_ms=fused,
                       top_kernels={k[:80]: v / runs / 1e3 for k, v in top})
        else:
            row.update(device_busy_ms="not measured")
        log("step", **row)
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        libraries=[p.name for p in build.library_paths().values()],
        torch=torch.__version__, cuda=torch.version.cuda)

    k = phase_kernels()
    serve_bf16 = phase_serve("bfloat16", "float32")
    serve_f32 = phase_serve("float32", "float16")
    for dtype in ("bfloat16", "float32"):
        phase_step(dtype)

    source = "dpot_tpu_torch/csrc/afno_fused.cu"
    replaces = "dpot_tpu/ops/pallas/afno_fused.py:113"
    kernels = []
    for name, key, served in (("fused_gn_afno[bf16,tanh]", "bfloat16/B8", serve_bf16),
                              ("fused_gn_afno[f32,erf]", "float32/B8", serve_f32)):
        r = k[key]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            phase=f"serve[{served['dtype']}]", shapes=key, check="pass",
            max_abs_limit=r["max_abs_limit"], rel_l2=r["rel_l2"],
            device_ms=r["device_ms"] and r["device_ms"]["total"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
