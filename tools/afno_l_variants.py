"""Where the bf16 kernel for 96-channel AFNO blocks (DPOT-L at 128^2) spends its time, on the card.

    python3 tools/afno_l_variants.py [--parent DIR] [--shapes L,LTP] [variant ...]

Builds copies of dpot_tpu_torch/csrc/afno_hopper_l.cu, each with one part
changed or taken out (VARIANTS below: text substitutions, so each copy is
the kernel minus exactly that part, or with a ring of another depth, or
with another synthesis launch), into build/afno_l_variants/, one nvcc each,
all at once. Besides them:
  - "stream": afno_hopper_stream.cu with its refusal of the 128- and
    256-px latents taken out, so that the streamed kernel runs at L's
    shapes (the yardstick: whether a kernel of L's own earns its place);
  - "parent" (with --parent DIR, a checkout of an earlier commit, e.g.
    unpacked by `git archive` into a directory that .gitignore lists): that
    commit's afno_hopper_l.cu as it is.
Then, at DPOT-L's block shapes at 128^2, patch 8 (HW 256, C 1536, 16 blocks
of 96, groups of 192, K 144) at B = 1, 8, 16 and 20, and at a tensor-
parallel rank's share (C 768, 8 blocks, 4 groups) at B = 1, 4 and 16,
N(0, 0.05^2) weights and tanh-GELU, it calls each copy through its C entry
point on the same inputs and prints, per shape and batch, each copy's time
per call (CUDA events over 30 back-to-back calls, and device time from
torch.profiler over 20: the union of its launches and each launch's own
time by kernel name, the split between the launches), each twice, in the
order given and then reversed, and its max abs error against the plain
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

SRC = build.SRC_DIR / "afno_hopper_l.cu"
STREAM_SRC = build.SRC_DIR / "afno_hopper_stream.cu"
OUT = build.BUILD_DIR.parent / "afno_l_variants"
# (name, C, nb, groups, batches): DPOT-L at a 16^2 latent, modes 32 (K 144),
# and a tensor-parallel rank's share of it over model = 2
SHAPES = (("L", 1536, 16, 8, (1, 8, 16, 20)), ("LTP", 768, 8, 4, (1, 4, 16)))
ENTRY = {"stream": "dpot_afno_hopper_stream"}  # the other copies: dpot_afno_hopper_l

_STATS_LAUNCH = """  l_stats_kernel<<<dim3(groups, B), STATS_NT, 0, s>>>(static_cast<const bf16*>(x), stats, HW, C,
                                                      groups);"""
_STATS_TRIGGER = """  // the spectral launch may take the SMs this grid leaves free; it waits
  // for the statistics before it reads them
  launch_dependents();"""
_STATS_END = """    st[1] = rsqrtf(var + EPS);
  }
}"""
_MLP_LOOP = """#pragma unroll
  for (int s = 0; s < 12; ++s) {"""
_ANALYSIS_LOOP = """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        za.template mma<1, 1>("""
_GRID = "const int tiles = nb * nch * B, grid = tiles < sms ? tiles : sms;"
_NORM_STORE = """        *reinterpret_cast<uint4*>(xt + p * 64 + (((lc & 3) ^ ((p >> 1) & 3)) << 4)) = u;"""
_SYN_LAUNCH = """  const long long ptiles = static_cast<long long>(HW / SYN_P) * B;
  if (C % 256 == 0 && 2 * ptiles * (C / 256) >= sms) return launch_synthesis_tn<256>(dev, a, s);
  if (ptiles * (C / 128) >= sms) return launch_synthesis_tn<128>(dev, a, s);
  return launch_synthesis_tn<64>(dev, a, s);"""
_NS = "constexpr int L_NS = 5;"
_NCH = "const int nch = (K + MC - 1) / MC - (drop ? 1 : 0);"

VARIANTS = {
    "base": [],
    # the GroupNorm statistics launch left out (the spectral and synthesis
    # launches read a cleared scratch)
    "no_stats": [(_STATS_LAUNCH, "")],
    # afno_hopper_stream.cu's statistics launch (its rows summed in a loop
    # of eight loads and a remainder) in place of l_stats_kernel
    "stream_stats": [(_STATS_LAUNCH, "  stream_stats_kernel<<<dim3(groups, B), STATS_NT, 0, s>>>("
                                     "static_cast<const bf16*>(x), stats, HW, C, groups);")],
    # the spectral launch allowed to start only once every statistics CTA
    # has written its group (the trigger at the end, not the start)
    "stats_late": [(_STATS_TRIGGER, ""),
                   (_STATS_END, "    st[1] = rsqrtf(var + EPS);\n  }\n  launch_dependents();\n}")],
    # the persistent grid at half the SMs (twice the tiles a CTA)
    "grid_half": [(_GRID, "const int tiles = nb * nch * B, grid = tiles < sms / 2 ? tiles : sms / 2;")],
    # the products of both MLP layers left out (their epilogues kept)
    "no_mlp_mma": [(_MLP_LOOP, "#pragma unroll\n  for (int s = 0; s < 0; ++s) {")],
    # the products of the analysis left out (the normalisation kept)
    "no_analysis_mma": [(_ANALYSIS_LOOP, "#pragma unroll\n      for (int kk = 0; kk < 0; ++kk)\n"
                                         "        za.template mma<1, 1>(")],
    # h without the activation (the bias kept)
    "no_act": [("    put96<ACT, true>(zh, acc, b1", "    put96<ACT_NONE, true>(zh, acc, b1")],
    # the x stages used as loaded, not rewritten as round(xn) in place
    "no_norm": [(_NORM_STORE, "")],
    # the synthesis launch left out
    "no_synthesis": [(_SYN_LAUNCH, "  return 0;")],
    # the synthesis launch of hopper_tma.cuh (all of o in a CTA, 128 x 128
    # tiles), which the design before used, in place of the streamed one
    "tma_synthesis": [(_SYN_LAUNCH, "  return launch_synthesis(x, Ainv, o, out, stats, gscale, "
                                    "gbias, B, HW, C, K, groups, s);")],
    # the synthesis at one tile width whatever the grid: 64 channels (two
    # CTAs an SM), 256 channels
    "syn64": [(_SYN_LAUNCH, "  return launch_synthesis_tn<64>(dev, a, s);")],
    "syn256": [(_SYN_LAUNCH, "  return launch_synthesis_tn<256>(dev, a, s);")],
    # the x ring four stages deep (five): the next tile's stages then land
    # only once this tile's analysis hands its own back
    "ring4": [(_NS, "constexpr int L_NS = 4;")],
    # the tail chunk's tiles (modes 128-143 of K 144) left out of the walk:
    # what the 48 empty rows of their products cost
    "drop_tail": [(_NCH, "const int nch = (K + MC - 1) / MC - 1;")],
    # o computed and never stored
    "no_o_store": [("    const int m0 = c * MC, rows = K - m0 < MC ? K - m0 : MC;",
                    "    const int m0 = c * MC, rows = 0;")],
}


def make(name: str, parent: Path | None = None) -> tuple[str, int, object, Path]:
    """Variant `name` built into OUT ("parent": the source of the checkout
    `parent`, as it is; "stream": the streamed kernel taking L's latents)."""
    src_dir = build.SRC_DIR
    if name == "parent":
        src_dir = parent / "dpot_tpu_torch" / "csrc"
        src = (src_dir / SRC.name).read_text()
    elif name == "stream":
        refusal = "  if ((HW == 128 || HW == 256) && K % 4 == 0 && (2 * K + 63) / 64 <= 5) return 0;\n"
        src = STREAM_SRC.read_text()
        if src.count(refusal) != 1:
            raise ValueError("stream: the refusal of the 128/256-px latents is not in the source once")
        src = src.replace(refusal, "")
    else:
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
    """Registers and spill stores of each kernel that ptxas -v reports."""
    usage, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(\w+_kernel)\w*'", ln)
        if m:
            fn = m[1]
        elif fn and (m := re.search(r"(\d+) bytes spill stores", ln)):
            usage[fn] = f"{m[1]} B spilled"
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            usage[fn] = f"{m[1]} registers, {usage.get(fn, '0 B spilled')}"
    return usage


def block_args(B: int, seed: int, C: int, nb: int):
    """bf16 kernel arguments at a 16^2 latent, modes 32 (K 144); the weights
    f32 (the plain version's) and their bf16 copies, each block transposed
    (the layout the kernels read)."""
    bs = C // nb
    kh, kw = kept_modes(16, 16, 32)
    rng = np.random.default_rng(seed)

    def t(shape, s=1.0, shift=0.0, dt=torch.float32):
        a = (shift + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    A, Ainv = combined_spectral_ops(16, 16, kh, kw, torch.bfloat16, torch.device("cuda"))
    args = (t((B, 256, C), dt=torch.bfloat16), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05),
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05))
    copies = [w.transpose(-1, -2).to(torch.bfloat16).contiguous() for w in (args[5], args[7])]
    return args, copies, kh * kw


def kernel_name(name: str) -> str:
    m = re.search(r"::(\w+_kernel)\b", name) or re.search(r"(\w+_kernel)\b", name)
    return m[1] if m else name


def device_ms(call, runs: int = 20) -> dict[str, float]:
    """Device time per call of `call` from torch.profiler: the union of its
    kernels' intervals ("total") and each kernel's own time by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA" and "_kernel" in e.name]
    out: dict[str, float] = {}
    for e in events:
        k = kernel_name(e.name)
        out[k] = out.get(k, 0.0) + e.time_range.elapsed_us() / runs / 1e3
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    out["total"] = total / runs / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier commit: its kernel is the variant 'parent'")
    ap.add_argument("--shapes", default=None,
                    help=f"comma-separated shape names of {[sh[0] for sh in SHAPES]} "
                         "(default: all)")
    ap.add_argument("variants", nargs="*", help="variant names (default: all, and 'stream')")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("afno_l_variants: needs a CUDA device", file=sys.stderr)
        return 2
    names = opts.variants or [*VARIANTS, "stream"]
    if opts.parent and "parent" not in names:
        names = ["parent", *names]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: make(n, opts.parent), names))
    fns = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, rc, note, so in built:
        print(json.dumps({"variant": name, "nvcc_rc": rc, "ptxas_or_log": note}), flush=True)
        if rc == 0:
            fn = getattr(ctypes.CDLL(str(so)), ENTRY.get(name, "dpot_afno_hopper_l"))
            fn.argtypes = [i] + [p] * 12 + [i] * 6 + [p]
            fn.restype = i
            fns[name] = fn
    aid = act_id("gelu", True)
    for shape, C, nb, groups, batches in SHAPES:
        if opts.shapes and shape not in opts.shapes.split(","):
            continue
        for B in batches:
            args, (w1t, w2t), K = block_args(B, B, C, nb)
            x, A, Ainv = args[0], args[3], args[4]
            stats = torch.empty(B * groups * 2, device="cuda")
            want = fused_gn_afno_ref(*args, K, groups, True).float()
            stream = torch.cuda.current_stream().cuda_stream
            row: dict = {"kernel": SRC.name, "shape": shape, "batch": B}
            for order in (names, names[::-1]):
                for name in order:
                    if name not in fns:
                        continue
                    # cleared scratch, so that a copy that leaves a part out
                    # reads no other copy's results
                    out = torch.zeros_like(x)
                    o = torch.zeros((B, 2 * K, C), device="cuda", dtype=torch.bfloat16)
                    stats.zero_()
                    ptrs = [t.data_ptr() for t in (x, args[1], args[2], A, Ainv, w1t,
                                                   args[6], w2t, args[8], stats, o, out)]

                    def call():
                        return fns[name](aid, *ptrs, B, 256, C, K, nb, groups, stream)

                    if (err := call()) != 0:
                        raise RuntimeError(f"variant {name}: launch failed ({err})")
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
