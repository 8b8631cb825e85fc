"""Where the streamed bf16 kernel of fused_gn_afno spends its time, on the card.

    python3 tools/afno_stream_variants.py [variant ...]

Builds copies of dpot_tpu_torch/csrc/afno_hopper_stream.cu, each with one
part changed or taken out (VARIANTS below: text substitutions, so each copy
is the kernel minus exactly that part, or with its ring of another depth),
into build/afno_stream_variants/, one nvcc each, all at once. Then, at the
block shapes of configs/pretrain_medium.yaml's DPOT-M at res 256 and 64
(C 1024, 8 blocks of 128; a 32^2 latent, K 544, and an 8^2 latent, K 40)
and of DPOT-L at res 256 (C 1536, 16 blocks of 96, groups of 192), at B = 1,
8 and 20 (L: 16), N(0, 0.05^2) weights and tanh-GELU, it calls each copy
through its C entry point on the same inputs and prints, per shape and
batch, each copy's time per call (CUDA events over 30 back-to-back calls,
twice, in the order given and then reversed) and its max abs error against
the plain version. A copy that takes work out computes a wrong answer; its
time says what that work costs. Prints the card's name and power limit
last.
"""

from __future__ import annotations

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
# (name, latent side, C, nb, groups, batches)
SHAPES = (("M256", 32, 1024, 8, 8, (1, 8, 20)), ("M64", 8, 1024, 8, 8, (1, 8, 20)),
          ("L256", 32, 1536, 16, 8, (1, 8, 16)))

_NORM = """          const float2 f = unpack_bf16(bx[nt][i]);
          bx[nt][i] = pack_bf16((f.x - nm[nt]) * nr[nt] + nbias[nt],
                                (f.y - nm[nt]) * nr[nt] + nbias[nt]);"""
_STATS_LAUNCH = """  stream_stats_kernel<<<dim3(a.groups, a.B), STATS_NT, 0, s>>>(a.x, a.stats, a.HW, a.C,
                                                                a.groups);"""
_SYN_LAUNCH = """  stream_synthesis_kernel<MT><<<dim3(a.HW / TP, a.C / TC, a.B), SYN_NT, SYN_SMEM, s>>>(
      a.Ainv, a.o, a.x, a.stats, a.gscale, a.gbias, a.out, a.HW, a.C, a.K, a.groups);"""

VARIANTS = {
    "base": [],
    # the spectral launch's ring two or four stages deep
    "two_stage": [("constexpr int NS = 3;", "constexpr int NS = 2;")],
    "four_stage": [("constexpr int NS = 3;", "constexpr int NS = 4;")],
    # the GroupNorm statistics launch left out
    "no_stats": [(_STATS_LAUNCH, "")],
    # x's fragments used as loaded, not normalised and rounded in registers
    "no_norm": [(_NORM, "")],
    # both MLP layers' chunk loops left out (z goes to o as it is)
    "no_mlp": [("  constexpr int NCH = BS / KW;\n", "  constexpr int NCH = 0;\n")],
    # the synthesis launch left out
    "no_synthesis": [(_SYN_LAUNCH, "")],
    # one warp-tile height whatever the batch
    "always_mt2": [("  const bool small = ", "  const bool small = false && ")],
    "always_mt1": [("  const bool small = ", "  const bool small = true || ")],
}


def make(name: str) -> tuple[str, int, str, Path]:
    """Variant `name` of the kernel built into OUT."""
    src = SRC.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: the text to replace is not in the source once")
        src = src.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                        "-Xptxas", "-v", "-o", str(so), str(cu)], capture_output=True, text=True)
    log = r.stdout + r.stderr
    return name, r.returncode, log[-3000:] if r.returncode else ptxas_usage(log), so


def ptxas_usage(log: str) -> dict[str, str]:
    """Registers and spill stores of each kernel instance that ptxas -v
    reports, by kernel name and template arguments (<BS, MT> or <MT>)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("afno_stream_variants: needs a CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(make, names))
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
        for B in batches:
            args, (w1t, w2t), K = block_args(B, B, side, C, nb)
            x = args[0]
            HW = x.shape[1]
            stats = torch.empty(B * groups * 2, device="cuda")
            o = torch.empty((B, 2 * K, C), device="cuda", dtype=torch.bfloat16)
            want = fused_gn_afno_ref(*args, K, groups, True).float()
            stream = torch.cuda.current_stream().cuda_stream
            row: dict = {"kernel": SRC.name, "shape": shape, "batch": B}
            for order in (names, names[::-1]):
                for name in order:
                    if name not in fns:
                        continue
                    out = torch.empty_like(x)
                    ptrs = [t.data_ptr() for t in (x, args[1], args[2], args[3], args[4], w1t,
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
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
