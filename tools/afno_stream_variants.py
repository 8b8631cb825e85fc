"""Where the streamed bf16 kernel of fused_gn_afno spends its time, on the card.

    python3 tools/afno_stream_variants.py [--parent DIR] [variant ...]

Builds copies of dpot_tpu_torch/csrc/afno_hopper_stream.cu, each with one
part changed or taken out (VARIANTS below: text substitutions, so each copy
is the kernel minus exactly that part, or with a ring of another depth, or
one chunk or tile width whatever the grid), into
build/afno_stream_variants/, one nvcc each, all at once. With --parent DIR
(a checkout of an earlier commit, e.g. unpacked by `git archive` into a
directory that .gitignore lists) it also builds that commit's
afno_hopper_stream.cu as the variant "parent", so that the two designs are
timed in one process on one card. Then, at the block shapes of
configs/pretrain_medium.yaml's DPOT-M at res 256, 64, 96, 72, 160 (patch 8)
and 64 (patch 16) (C 1024, 8 blocks of 128; latents 32^2 with K 544, 8^2
with K 40, 12^2, 9^2, 20^2 and 4^2) and of DPOT-L at res 256 (C 1536, 16
blocks of 96, groups of 192), at B = 1, 8 and 20 (L: 16), N(0, 0.05^2)
weights and tanh-GELU, it calls each copy through its C entry point on
the same inputs (A and Ainv zero-padded as each copy's source pads them:
K to even for the parent, to a multiple of 4 here) and prints, per shape
and batch, each copy's time per call (CUDA events over 30 back-to-back
calls, and device time from torch.profiler over 20, each twice, in the
order given and then reversed) and its max abs error against the plain
version. A copy that takes work out computes a wrong answer; its time says
what that work costs. Prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dpot_tpu_torch.ops.cuda import build  # noqa: E402
from dpot_tpu_torch.ops.cuda.afno_fused import act_id, fused_gn_afno_ref  # noqa: E402
from dpot_tpu_torch.ops.spectral import combined_spectral_ops, kept_modes  # noqa: E402

SRC = build.SRC_DIR / "afno_hopper_stream.cu"
OUT = build.BUILD_DIR.parent / "afno_stream_variants"
# (name, latent side, C, nb, groups, batches): DPOT-M at res 256, 64, 96,
# 72, 160 (patch 8) and 64 (patch 16), DPOT-L at res 256
SHAPES = (("M256", 32, 1024, 8, 8, (1, 8, 20)), ("M64", 8, 1024, 8, 8, (1, 8, 20)),
          ("L256", 32, 1536, 16, 8, (1, 8, 16)), ("M96", 12, 1024, 8, 8, (1, 8, 20)),
          ("M72", 9, 1024, 8, 8, (1, 8, 20)), ("M160", 20, 1024, 8, 8, (1, 8, 20)),
          ("M64p16", 4, 1024, 8, 8, (1, 8, 20)))
# the unit each source rounds K up to (its `Kp`): the parent's design took
# an even K, this one a multiple of 4
K_UNIT = {"parent": 2}

_STATS_LAUNCH = """  stream_stats_kernel<<<dim3(groups, B), STATS_NT, 0, s>>>(a.x, stats, HW, C, groups);"""
_NORM = """      for (int e = 0; e < 4; ++e)
        hq[e] = __floats2bfloat162_rn((f[2 * e] - nm[2 * e]) * nr[2 * e] + nbi[2 * e],
                                      (f[2 * e + 1] - nm[2 * e + 1]) * nr[2 * e + 1] +
                                          nbi[2 * e + 1]);
      *reinterpret_cast<uint4*>(xt + (lc >> 3) * BOX + p * 128 + (((lc & 7) ^ (p & 7)) << 4)) = u;"""
_SYN_LAUNCH = """  if (C % 256 == 0 && tiles * (C / 256) >= sms) return launch_synthesis_tn<256>(dev, a, s);
  if (C % 128 == 0 && tiles * (C / 128) >= sms) return launch_synthesis_tn<128>(dev, a, s);
  return launch_synthesis_tn<64>(dev, a, s);"""
_ACT_ONCE = """  switch (act) {
    case ACT_GELU_TANH: return store_h_act<ACT_GELU_TANH>(zh, acc, bias);
    case ACT_GELU_ERF: return store_h_act<ACT_GELU_ERF>(zh, acc, bias);
    case ACT_TANH: return store_h_act<ACT_TANH>(zh, acc, bias);
    case ACT_SIGMOID: return store_h_act<ACT_SIGMOID>(zh, acc, bias);
    case ACT_RELU: return store_h_act<ACT_RELU>(zh, acc, bias);
    case ACT_LEAKY_RELU: return store_h_act<ACT_LEAKY_RELU>(zh, acc, bias);
    case ACT_SOFTPLUS: return store_h_act<ACT_SOFTPLUS>(zh, acc, bias);
    case ACT_ELU: return store_h_act<ACT_ELU>(zh, acc, bias);
    default: return store_h_act<ACT_SILU>(zh, acc, bias);
  }"""
_ACT_EACH = """  auto f = [act](float v) {
    switch (act) {
      case ACT_GELU_TANH: return activate<ACT_GELU_TANH>(v);
      case ACT_GELU_ERF: return activate<ACT_GELU_ERF>(v);
      case ACT_TANH: return activate<ACT_TANH>(v);
      case ACT_SIGMOID: return activate<ACT_SIGMOID>(v);
      case ACT_RELU: return activate<ACT_RELU>(v);
      case ACT_LEAKY_RELU: return activate<ACT_LEAKY_RELU>(v);
      case ACT_SOFTPLUS: return activate<ACT_SOFTPLUS>(v);
      case ACT_ELU: return activate<ACT_ELU>(v);
      default: return activate<ACT_SILU>(v);
    }
  };
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = acc_col(i);
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *swizzled(zh, BOX, acc_row(h), c) = __floats2bfloat162_rn(
          f(acc.d[4 * i + 2 * h] + bv.x), f(acc.d[4 * i + 2 * h + 1] + bv.y));
  }"""
_SPEC_NS = "static constexpr int NS = BS == 96 || BS == 128 ? 4 : 3;"
_SYN_NS = "static constexpr int NS = TN == 256 ? 3 : 4;"

VARIANTS = {
    "base": [],
    # the GroupNorm statistics launch left out (the spectral and synthesis
    # launches read whatever the scratch holds)
    "no_stats": [(_STATS_LAUNCH, "")],
    # the x tiles used as loaded, not rewritten as round(xn) in place
    "no_norm": [(_NORM, "")],
    # both MLP layers left out: no weight stages loaded or computed (z's
    # accumulator goes to o as h would)
    "no_mlp": [("      for (int layer = 0; layer < 2; ++layer)",
                "      for (int layer = 0; layer < 0; ++layer)"),
               ("  zero(acc);\n#pragma unroll\n  for (int t = 0; t < 2 * G::NKB; ++t) {",
                "  zero(acc);\n#pragma unroll\n  for (int t = 0; t < 0; ++t) {")],
    # the synthesis launch left out
    "no_synthesis": [(_SYN_LAUNCH, "  return 0;")],
    # the spectral ring three or five stages deep at blocks of 96 and 128
    # (four), the synthesis ring three deep at tiles of 128 and 64 (four)
    "spectral_ring3": [(_SPEC_NS, "static constexpr int NS = 3;")],
    "spectral_ring5": [(_SPEC_NS, "static constexpr int NS = BS == 96 || BS == 128 ? 5 : 3;")],
    "synthesis_ring3": [(_SYN_NS, "static constexpr int NS = 3;")],
    # every consumer thread arrives on a stage's "empty" barrier, not one
    # thread a warpgroup
    "arrive_every_thread": [("constexpr int EMPTY_ARRIVALS = 2;",
                             "constexpr int EMPTY_ARRIVALS = NC;"),
                            ("  if ((threadIdx.x & 127) == 0) mbar_arrive(bar);",
                             "  mbar_arrive(bar);")],
    # the statistics launch at 256 threads a CTA (512)
    "stats_256": [("constexpr int STATS_NT = 512;", "constexpr int STATS_NT = 256;")],
    # o computed and never stored
    "no_o_store": [("  const int rows = kstore - m0 < MC ? kstore - m0 : MC;",
                    "  const int rows = 0;")],
    # the activation chosen by a switch at every element of h (in the
    # unrolled epilogue), not once
    "act_per_element": [(_ACT_ONCE, _ACT_EACH)],
}


def make(name: str, parent: Path | None = None) -> tuple[str, int, str, Path]:
    """Variant `name` of the kernel built into OUT ("parent": the source of
    the checkout `parent`, as it is)."""
    if name == "parent":
        src_dir = parent / "dpot_tpu_torch" / "csrc"
        src = (src_dir / SRC.name).read_text()
    else:
        src_dir = build.SRC_DIR
        src = SRC.read_text()
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: the text to replace is not in the source once")
            src = src.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir),
                        "-Xptxas", "-v", "-o", str(so), str(cu)], capture_output=True, text=True)
    log = r.stdout + r.stderr
    return name, r.returncode, log[-3000:] if r.returncode else ptxas_usage(log), so


def ptxas_usage(log: str) -> dict[str, str]:
    """Registers and spill stores of each kernel instance that ptxas -v
    reports, by kernel name and template arguments."""
    usage, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(stream_(?:stats|spectral|synthesis)_kernel)"
                      r"I((?:Li\d+E)*)", ln)
        if m:
            fn = f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
        elif fn and (m := re.search(r"(\d+) bytes spill stores", ln)):
            usage[fn] = f"{m[1]} B spilled"
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            usage[fn] = f"{m[1]} registers, {usage.get(fn, '0 B spilled')}"
    return usage


def block_args(B: int, seed: int, side: int, C: int, nb: int):
    """bf16 kernel arguments at a side x side latent, modes 32; the weights
    f32 (the plain version's) and their bf16 copies, each block transposed
    (the layout the kernel reads)."""
    bs = C // nb
    kh, kw = kept_modes(side, side, 32)
    rng = np.random.default_rng(seed)

    def t(shape, s=1.0, shift=0.0, dt=torch.float32):
        a = (shift + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    A, Ainv = combined_spectral_ops(side, side, kh, kw, torch.bfloat16, torch.device("cuda"))
    args = (t((B, side * side, C), dt=torch.bfloat16), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05),
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05))
    copies = [w.transpose(-1, -2).to(torch.bfloat16).contiguous() for w in (args[5], args[7])]
    return args, copies, kh * kw


def padded(A: torch.Tensor, Ainv: torch.Tensor, K: int, k_unit: int):
    """A (2K, HW) and Ainv (HW, 2K) zero-padded to HWp = HW rounded up to 64
    and Kp = K rounded up to k_unit, as the wrapper's `padded_ops` pads them
    for the kernel that reads them."""
    HW = A.shape[1]
    HWp, Kp = -(-HW // 64) * 64, -(-K // k_unit) * k_unit
    Ap = A.new_zeros((2 * Kp, HWp))
    Ap[:K, :HW], Ap[Kp:Kp + K, :HW] = A[:K], A[K:]
    Ainvp = Ainv.new_zeros((HWp, 2 * Kp))
    Ainvp[:HW, :K], Ainvp[:HW, Kp:Kp + K] = Ainv[:, :K], Ainv[:, K:]
    return Ap, Ainvp, Kp


def device_ms(call, runs: int = 20) -> float:
    """Device time per call of `call` (the union of its kernels' intervals),
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA" and "stream_" in e.name)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / runs / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit: its kernel is the variant 'parent'")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help=f"shape names of {[sh[0] for sh in SHAPES]} (default: all)")
    ap.add_argument("variants", nargs="*", help="variant names (default: all)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("afno_stream_variants: needs a CUDA device", file=sys.stderr)
        return 2
    names = opts.variants or list(VARIANTS)
    if opts.parent and "parent" not in names:
        names = ["parent", *names]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: make(n, opts.parent), names))
    fns = {}
    for name, rc, note, so in built:
        print(json.dumps({"variant": name, "nvcc_rc": rc, "ptxas_or_log": note}), flush=True)
        if rc == 0:
            fn = ctypes.CDLL(str(so)).dpot_afno_hopper_stream
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [i] + [p] * 12 + [i] * 6 + [p]
            fn.restype = i
            fns[name] = fn
    aid = act_id("gelu", True)
    for shape, side, C, nb, groups, batches in SHAPES:
        if opts.shapes and shape not in opts.shapes:
            continue
        for B in batches:
            args, (w1t, w2t), K = block_args(B, B, side, C, nb)
            x = args[0]
            HW = x.shape[1]
            stats = torch.empty(B * groups * 2, device="cuda")
            ops = {u: padded(args[3], args[4], K, u) for u in {2, 4}}
            want = fused_gn_afno_ref(*args, K, groups, True).float()
            stream = torch.cuda.current_stream().cuda_stream
            row: dict = {"kernel": SRC.name, "shape": shape, "batch": B}
            for order in (names, names[::-1]):
                for name in order:
                    if name not in fns:
                        continue
                    out = torch.empty_like(x)
                    Ap, Ainvp, Kp = ops[K_UNIT.get(name, 4)]
                    o = torch.empty((B, 2 * Kp, C), device="cuda", dtype=torch.bfloat16)
                    ptrs = [t.data_ptr() for t in (x, args[1], args[2], Ap, Ainvp, w1t,
                                                   args[6], w2t, args[8], stats, o, out)]

                    def call():
                        return fns[name](aid, *ptrs, B, HW, C, K, nb, groups, stream)

                    if call() != 0:
                        raise RuntimeError(f"variant {name}: launch failed")
                    torch.cuda.synchronize()
                    row.setdefault(f"{name}_max_abs_err",
                                   (out.float() - want).abs().max().item())
                    for _ in range(3):
                        call()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(30):
                        call()
                    end.record()
                    end.synchronize()
                    row.setdefault(f"{name}_ms", []).append(start.elapsed_time(end) / 30)
                    row.setdefault(f"{name}_device_ms", []).append(device_ms(call))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
