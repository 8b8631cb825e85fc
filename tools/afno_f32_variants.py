"""Where the f32 Hopper kernels of fused_gn_afno spend their time, on the card.

    python3 tools/afno_f32_variants.py [--wide] [variant ...]

Builds copies of dpot_tpu_torch/csrc/afno_hopper_f32.cu (with --wide, of
afno_hopper_f32_wide.cu, with the 128-channel file it includes written
inline), each with one part changed or taken out (VARIANTS below: text
substitutions, so each copy is the kernel minus exactly that part), into
build/afno_f32_variants/, one nvcc each, all at once. Then, at the DPOT-Ti
block shapes (with --wide, DPOT-H's: C 2048, 8 blocks of 256 channels)
(B = 1, 8, 20, N(0, 0.05^2) weights, erf-GELU), it calls each copy through
its C entry point on the same inputs and prints, per batch, each copy's time per call
(CUDA events over 50 back-to-back calls, twice, in the order given and
then reversed) and its max abs error against the plain version. A copy
that takes work out computes a wrong answer; its time says what that work
costs. Prints the card's name and power limit last.
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

SRC = build.SRC_DIR / "afno_hopper_f32.cu"
WIDE_SRC = build.SRC_DIR / "afno_hopper_f32_wide.cu"
OUT = build.BUILD_DIR.parent / "afno_f32_variants"
# the block geometry of each kernel's model: (C, nb)
GEOMETRY = {False: (512, 4), True: (2048, 8)}

_PROMOTED = """      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, al[mt], bh[nt]);
      mma_tf32(d, ah[mt], bl[nt]);
      mma_tf32(d, ah[mt], bh[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];"""
_SPLIT = """  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));"""
_SYN_LAUNCH = """  synthesis_f32_kernel<MT><<<dim3(HW / TP, C / TC, B), NT_SYN, SYN_SMEM, s>>>(
      Ainv, o, x, stats, gscale, gbias, out, HW, C, K, groups);"""

VARIANTS = {
    "base": [],
    # the three products chained in the mma accumulator, no f32 promotion
    "chain": [(_PROMOTED, """      mma_tf32(acc[mt][nt], al[mt], bh[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bh[nt]);""")],
    # one product (hi.hi') per step: what two of the three mma cost
    "one_mma": [(_PROMOTED, """      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(d, ah[mt], bh[nt]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];""")],
    # the split by cvt.rna.tf32.f32 (the same rounding as the integer ops)
    "cvt_split": [(_SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));""")],
    # lo left unrounded: the tensor core reads its top 19 bits
    "raw_lo": [(_SPLIT, """  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));""")],
    # weight chunks after the first of each layer not loaded
    "no_weight_stream": [(
        "      load_w_chunk(sm + ((ci + 1) & 1) * STAGE, w, j, nb, ci + 1);\n", "")],
    # the GroupNorm statistics pass over the slab skipped
    "no_stats": [("for (int p = tid >> 5; p < HW; p += 8) {",
                  "for (int p = tid >> 5; p < 0; p += 8) {")],
    # launch 1's three products at a third: the weights still streamed, so
    # what is left is the rest of the kernel's time
    "one_mma_no_weight_stream": [],
    # launch 2 left out: launch 1 alone
    "no_synthesis": [(_SYN_LAUNCH, "")],
    # one warp-tile height whatever the batch: 32-mode chunks and 64-px
    # synthesis tiles (MT = 2), or 16-mode chunks and 32-px tiles (MT = 1)
    "always_mt2": [("  const bool small = ", "  const bool small = false && ")],
    "always_mt1": [("  const bool small = ", "  const bool small = true || ")],
    # launch 2 as a programmatic dependent launch, triggered at launch 1's start
    "pdl": [
        ("  const float* xb = x + static_cast<size_t>(b) * HW * C + j * BS;\n",
         "  const float* xb = x + static_cast<size_t>(b) * HW * C + j * BS;\n"
         "  asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n"),
        ("  for (int s = 0; s < SYN_STAGES - 1; ++s) {\n    if (s < nk) {",
         "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
         "  for (int s = 0; s < SYN_STAGES - 1; ++s) {\n    if (s < nk) {"),
        (_SYN_LAUNCH, """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HW / TP, C / TC, B);
  cfg.blockDim = dim3(NT_SYN);
  cfg.dynamicSmemBytes = SYN_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, synthesis_f32_kernel<MT>, Ainv,
                              static_cast<const float*>(o), x,
                              static_cast<const float*>(stats), gscale, gbias, out, HW, C, K,
                              groups)) != cudaSuccess)
    return e;"""),
    ],
}


VARIANTS["one_mma_no_weight_stream"] = VARIANTS["one_mma"] + VARIANTS["no_weight_stream"]
# the wide kernel's own text where it differs from the 128-channel one's
WIDE_TEXT = {"for (int p = tid >> 5; p < HW; p += 8) {":
             "for (int p = tid / COLS; p < HW; p += RSTEP) {",
             "for (int p = tid >> 5; p < 0; p += 8) {":
             "for (int p = tid / COLS; p < 0; p += RSTEP) {"}


def make(name: str, wide: bool) -> tuple[str, int, str, Path]:
    """Variant `name` of the kernel built into OUT. For the wide kernel a
    substitution applies to its own text where that holds the text once,
    else to the included 128-channel file's (the split, the products)."""
    parts = [SRC.read_text()]
    if wide:
        parts = WIDE_SRC.read_text().split('#include "afno_hopper_f32.cu"')
        parts.insert(1, SRC.read_text())
    for old, new in VARIANTS[name]:
        if wide:
            old, new = WIDE_TEXT.get(old, old), WIDE_TEXT.get(new, new)
        where = [i for i in ([2, 1] if wide else [0]) if parts[i].count(old) == 1]
        if not where:
            raise ValueError(f"variant {name}: the text to replace is not in the source once")
        parts[where[0]] = parts[where[0]].replace(old, new)
    src = "".join(parts)
    tag = f"{name}_wide" if wide else name
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(src)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                        "-Xptxas", "-v", "-o", str(so), str(cu)], capture_output=True, text=True)
    log = r.stdout + r.stderr
    return name, r.returncode, log[-3000:] if r.returncode else ptxas_usage(log), so


def ptxas_usage(log: str) -> dict[str, str]:
    """Registers and spill stores of each kernel instance that ptxas -v
    reports, by kernel name and template arguments (<ActId, MT>)."""
    usage, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:spectral|synthesis)\w*?_kernel)"
                      r"I((?:Li\d+E)*)", ln)
        if m:
            fn = f"{m[1]}<{','.join(re.findall(r'Li(\d+)E', m[2]))}>"
        elif fn and (m := re.search(r"(\d+) bytes spill stores", ln)):
            usage[fn] = f"{m[1]} B spilled"
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            usage[fn] = f"{m[1]} registers, {usage.get(fn, '0 B spilled')}"
    return usage


def block_args(B: int, seed: int, C: int, nb: int):
    H = W = 16
    modes, groups = 32, 8
    bs = C // nb
    kh, kw = kept_modes(H, W, modes)
    rng = np.random.default_rng(seed)

    def t(shape, s=1.0, shift=0.0):
        a = (shift + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    A, Ainv = combined_spectral_ops(H, W, kh, kw, torch.float32, torch.device("cuda"))
    return (t((B, H * W, C)), t((C,), 0.1, 1.0), t((C,), 0.1), A, Ainv,
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05),
            t((2, nb, bs, bs), 0.05), t((2, nb, bs), 0.05)), kh * kw, groups


def main() -> int:
    if not torch.cuda.is_available():
        print("afno_f32_variants: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    wide = "--wide" in sys.argv[1:]
    names = [a for a in sys.argv[1:] if a != "--wide"] or list(VARIANTS)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = list(ex.map(lambda n: make(n, wide), names))
    fns = {}
    for name, rc, note, so in built:
        print(json.dumps({"variant": name, "nvcc_rc": rc, "ptxas_or_log": note}), flush=True)
        if rc == 0:
            lib = ctypes.CDLL(str(so))
            fn = lib.dpot_afno_hopper_f32_wide if wide else lib.dpot_afno_hopper_f32
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [i] + [p] * 12 + [i] * 6 + [p]
            fn.restype = i
            fns[name] = fn
    aid = act_id("gelu", False)
    for B in (1, 8, 20):
        args, K, groups = block_args(B, B, *GEOMETRY[wide])
        x = args[0]
        _, HW, C = x.shape
        nb = args[5].shape[1]
        stats = torch.empty(B * groups * 2, device="cuda")
        o = torch.empty((B, 2 * K, C), device="cuda")
        want = fused_gn_afno_ref(*args, K, groups, False)
        stream = torch.cuda.current_stream().cuda_stream
        row: dict = {"kernel": WIDE_SRC.name if wide else SRC.name, "batch": B}
        for order in (names, names[::-1]):
            for name in order:
                if name not in fns:
                    continue
                out = torch.empty_like(x)
                ptrs = [t.data_ptr() for t in (*args, stats, o, out)]

                def call():
                    return fns[name](aid, *ptrs, B, HW, C, K, nb, groups, stream)

                if call() != 0:
                    raise RuntimeError(f"variant {name}: launch failed")
                torch.cuda.synchronize()
                row.setdefault(f"{name}_max_abs_err", (out - want).abs().max().item())
                for _ in range(5):
                    call()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    call()
                end.record()
                end.synchronize()
                row.setdefault(f"{name}_ms", []).append(start.elapsed_time(end) / 50)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
