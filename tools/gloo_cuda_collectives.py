"""Which collectives gloo carries for CUDA tensors, with two ranks on one card
(the only way two ranks share a card: nccl refuses it). Torch alone, no
code of the port.

    python3 tools/gloo_cuda_collectives.py

Each case runs in its own torchrun launch of 2 ranks on cuda:0 (a crash
ends the launch, not the survey): c10d's all_reduce, all_gather_into_tensor
and reduce_scatter_tensor; DDP over an nn.Linear; FSDP2 (`fully_shard`)
over an nn.Linear, forward and backward; and DTensor's `full_tensor` (the
functional collectives' all-gather). Prints one JSON line per case with
torchrun's exit code, the exit codes it reports for failed ranks (-11:
SIGSEGV) and the ranks' result lines, then the card's name and power
limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

CASES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "ddp", "fsdp2",
         "full_tensor")


def rank(case: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    r, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(8.0, device="cuda") + r
    if case == "all_reduce":
        dist.all_reduce(x)
        out = x
    elif case == "all_gather_into_tensor":
        out = torch.empty(8 * world, device="cuda")
        dist.all_gather_into_tensor(out, x)
    elif case == "reduce_scatter_tensor":
        out = torch.empty(8 // world, device="cuda")
        dist.reduce_scatter_tensor(out, x)
    elif case == "ddp":
        lin = torch.nn.parallel.DistributedDataParallel(torch.nn.Linear(8, 8, device="cuda"),
                                                        device_ids=[0])
        lin(x[None]).sum().backward()
        out = lin.module.weight.grad
    elif case == "fsdp2":
        from torch.distributed.fsdp import fully_shard

        lin = torch.nn.Linear(8, 8, device="cuda")
        fully_shard(lin)
        lin(x[None]).sum().backward()
        out = lin.weight.grad.to_local()
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

        mesh = init_device_mesh("cuda", (world,))
        out = distribute_tensor(x.reshape(2, 4), mesh, [Shard(0)],
                                src_data_rank=None).full_tensor()
    torch.cuda.synchronize()
    print(json.dumps({"rank": r, "sum": float(out.sum())}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    for case in CASES:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
             __file__, "rank", case], capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        failed = [int(c) for c in re.findall(r"exitcode\s*:\s*(-?\d+)", proc.stderr)]
        print(json.dumps({"case": case, "exit": proc.returncode, "rank_exits": failed,
                          "ranks": lines[-2:]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank(sys.argv[2])
    else:
        sys.exit(main())
