"""TF32 tensor-core rates on the card, to choose between mma.sync and wgmma
for the f32 Hopper kernel of fused_gn_afno.

    python3 tools/tf32_rate.py

Builds tools/tf32_rate.cu (which includes dpot_tpu_torch/csrc/afno_hopper_f32.cu
for its inner loop) into build/tf32_rate/ and runs, each on every SM:
  - mma_sync: mma.sync m16n8k8 tf32 from registers, 8 warps per CTA;
  - inner_loop_mt1, inner_loop_mt2: the f32 kernel's mma_k8 (fragment loads
    from shared memory, the register split, three mma, the f32 promotion)
    on tiles that stay in shared memory, two CTAs per SM as in the kernel;
  - wgmma_ss, wgmma_rs: wgmma m64n128k8 tf32 with both operands in shared
    memory, or A in registers; two warpgroups per CTA.
Before timing, one pass of each wgmma form is held against a float64
product of the same TF32 values (exact products, so only the order of the
f32 sums differs: 1e-5 of the largest value). Prints one JSON line per
kernel: the median CUDA-event time of three launches, the TF32 operations
per second, and for the inner loop the f32 products per second it reaches
(a third of its TF32 operations). Prints the card's name and power limit
last.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from dpot_tpu_torch.ops.cuda import build  # noqa: E402
from dpot_tpu_torch.ops.cuda.afno_fused import tf32_split  # noqa: E402

SRC = Path(__file__).resolve().with_name("tf32_rate.cu")
OUT = build.BUILD_DIR.parent / "tf32_rate"

# name: (which, CTAs per SM, iterations, TF32 operations per CTA and iteration)
KERNELS = {
    "mma_sync": (0, 4, 8192, 8 * 8 * 2 * 16 * 8 * 8),
    "inner_loop_mt1": (1, 2, 2048, 3 * 8 * 4 * 2 * 16 * 32 * 8),
    "inner_loop_mt2": (2, 2, 1024, 3 * 8 * 4 * 2 * 32 * 32 * 8),
    "wgmma_ss": (3, 2, 4096, 2 * 16 * 2 * 64 * 128 * 8),
    "wgmma_rs": (4, 2, 4096, 2 * 16 * 2 * 64 * 128 * 8),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("tf32_rate: needs a CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "tf32_rate.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SRC_DIR),
                        "-o", str(so), str(SRC)], capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(so)).tf32_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    gen = torch.Generator().manual_seed(0)
    x = tf32_split(torch.randn(256, 32, generator=gen))[0]  # exact TF32 values
    want = (x[:128].double() @ x[128:].double().T).float()
    x = x.cuda()
    ok = True
    for name, which in (("wgmma_ss", 5), ("wgmma_rs", 6)):
        out = torch.zeros(128, 128, device="cuda")
        if fn(which, x.data_ptr(), out.data_ptr(), 1, 1, stream) != 0:
            raise RuntimeError(f"{name} check: launch failed")
        torch.cuda.synchronize()
        err = (out.cpu() - want).abs().max().item() / want.abs().max().item()
        ok &= err <= 1e-5
        print(json.dumps({"check": name, "max_rel_err": err, "limit": 1e-5}), flush=True)

    for name, (which, per_sm, iters, ops) in KERNELS.items():
        blocks = per_sm * sms
        out = torch.empty(blocks * 256, device="cuda")

        def launch():
            if fn(which, x.data_ptr(), out.data_ptr(), iters, blocks, stream) != 0:
                raise RuntimeError(f"{name}: launch failed")

        launch()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        tflops = blocks * iters * ops / (ms * 1e-3) / 1e12
        row = {"kernel": name, "ctas": blocks, "iters": iters, "ms": ms, "ms_each": times,
               "tf32_tflops": tflops}
        if name.startswith("inner_loop"):
            row["f32_product_tflops"] = tflops / 3
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
