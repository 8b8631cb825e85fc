"""Which of the collectives that tensor, pipeline and spatial parallelism
need gloo carries for CUDA tensors, with two ranks on one card (the only way
two ranks share a card: nccl refuses it). Torch alone, no code of the port;
tools/gloo_cuda_collectives.py surveys the data-parallel ones.

    python3 tools/gloo_cuda_layouts.py

Each case runs in its own torchrun launch of 2 ranks on cuda:0 (a crash
ends the launch, not the survey): `all_to_all_single` (the pencil FFT's
transposes), `send`/`recv` and `batch_isend_irecv` (a pipeline's permute),
`broadcast` (a pipeline's last stage, a TP server's requests), and
`all_gather_into_tensor` on a group made by `new_group` (the mesh's axis
groups). Each rank checks its result against what the collective should
give and prints it as one JSON line; the survey prints one JSON line per
case with torchrun's exit code, the exit codes it reports for failed ranks
(-11: SIGSEGV) and the ranks' lines, then torch's version and the card's
name and power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

CASES = ("all_to_all_single", "send_recv", "batch_isend_irecv", "broadcast",
         "new_group_all_gather")


def rank(case: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    r, world = dist.get_rank(), dist.get_world_size()
    x = torch.arange(8.0, device="cuda") + 100 * r
    if case == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        n = 8 // world
        want = torch.cat([torch.arange(r * n, (r + 1) * n, device="cuda") + 100.0 * s
                          for s in range(world)])
    elif case == "send_recv":
        out = torch.empty_like(x)
        if r == 0:
            dist.send(x, 1)
            dist.recv(out, 1)
        else:
            dist.recv(out, 0)
            dist.send(x, 0)
        want = torch.arange(8.0, device="cuda") + 100 * (1 - r)
    elif case == "batch_isend_irecv":
        out = torch.empty_like(x)
        nxt, prv = (r + 1) % world, (r - 1) % world
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                          dist.P2POp(dist.irecv, out, prv)]):
            w.wait()
        want = torch.arange(8.0, device="cuda") + 100 * prv
    elif case == "broadcast":
        out = x.clone()
        dist.broadcast(out, src=world - 1)
        want = torch.arange(8.0, device="cuda") + 100 * (world - 1)
    else:
        group = dist.new_group(list(range(world)))
        out = torch.empty(8 * world, device="cuda")
        dist.all_gather_into_tensor(out, x, group=group)
        want = torch.cat([torch.arange(8.0, device="cuda") + 100 * s for s in range(world)])
    torch.cuda.synchronize()
    print(json.dumps({"rank": r, "right": bool(torch.equal(out, want)),
                      "sum": float(out.sum())}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    for case in CASES:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
             __file__, "rank", case], capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        failed = [int(c) for c in re.findall(r"exitcode\s*:\s*(-?\d+)", proc.stderr)]
        print(json.dumps({"case": case, "exit": proc.returncode, "rank_exits": failed,
                          "ranks": lines[-2:], "stderr_tail": proc.stderr[-300:]
                          if proc.returncode else ""}), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        rank(sys.argv[2])
    else:
        sys.exit(main())
