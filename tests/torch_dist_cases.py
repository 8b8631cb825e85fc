"""Rank programs of the port's multi-process CPU tests (test_torch_ddp.py,
test_torch_fsdp.py, the layout tests), and `launch` / `start`, which run one
of them on N gloo ranks.

A rank runs as `python tests/torch_dist_cases.py CASE OUT_DIR ARGS_JSON`
with torchrun's variables set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), starts the process group (gloo, or args['backend']) with a
timeout, runs CASE and saves
what it returns to OUT_DIR/rank{r}.pt (its output to OUT_DIR/rank{r}.log).
`launch` gives the ranks a free port and kills them all when they outlast
their time limit, so that a hung collective fails one test.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CPU tests' tiny DPOT, on a synthetic set whose 13 train samples make an
# 8-sample batch and a 5-sample tail that does not divide over 2 ranks
SPEC = dict(train_size=13, test_size=11, t_total=10, t_test=3, in_size=(16, 16),
            n_channels=2)
TINY = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "32",
        "--n_layers", "1", "--n_blocks", "4", "--modes", "4", "--T_in", "6",
        "--batch_size", "8", "--num_workers", "1", "--lr", "1e-3", "--warmup_epochs", "1",
        "--device", "cpu"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(case: str, out_dir, args: dict, world: int = 2, timeout: float = 120.0) -> list:
    """Run `case` on `world` gloo ranks; the ranks' results, in rank order."""
    return start(case, out_dir, args, world, timeout)()


def start(case: str, out_dir, args: dict, world: int = 2, timeout: float = 120.0):
    """Start `case` on `world` gloo ranks and return a function that waits
    for them (within `timeout` of the start, else kills them all and
    fails) and returns their results, in rank order: the caller works
    while the ranks run."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "wb"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(out_dir), json.dumps(args)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
            stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    return lambda: _finish(case, out_dir, procs, logs, deadline, timeout)


def _finish(case, out_dir, procs, logs, deadline, timeout) -> list:
    import torch

    world = len(procs)
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{case}: the ranks did not finish within {timeout} s")
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log"), errors="replace") as f:
                tail = f.read()[-6000:]
            raise AssertionError(f"rank {r} of {case} exited {p.returncode}:\n{tail}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def block_cache_marks(model):
    """Records, at each forward of an AFNO module of `model`, whether the
    w1 and w2 it read kept the bf16 kernels' weight cache on (under FSDP2
    they are the gathered parameters, marked off by parallel/fsdp.py)."""
    from dpot_tpu_torch.models.dpot import AFNO2D

    marks = []

    def hook(m, args, out):
        marks.append(getattr(m.w1, "_dpot_block_cache", True)
                     or getattr(m.w2, "_dpot_block_cache", True))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, AFNO2D)]
    try:
        yield marks
    finally:
        for h in handles:
            h.remove()


def replica_check(state) -> dict:
    """check_replica_consistency (utils/inspection.py) over the ranks of the
    state's 'data' axis, which hold the same tensors (a pipeline's or a
    tensor-parallel layout's other ranks do not): the count of tensors it
    compared, and the error it raised for a control in which the axis's
    second rank's copy of the first replicated parameter is one ulp off in
    one element (None where nothing is compared: a 'data' axis of one
    rank, or no replicated parameter)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dpot_tpu_torch.utils.inspection import check_replica_consistency

    if state.world < 2:
        return {"compared": 0, "control": None}
    model, group = state.model, state.data_group
    compared = check_replica_consistency(model, group=group)
    p = next((p for p in model.parameters() if not isinstance(p, DTensor)), None)
    control = None
    if compared and p is not None:
        saved = p.detach().clone()
        with torch.no_grad():
            if dist.get_rank(group) == 1:
                flat = p.view(-1)
                flat[:1] = torch.nextafter(flat[:1], torch.full_like(flat[:1], float("inf")))
            try:
                check_replica_consistency(model, group=group)
            except AssertionError as e:
                control = str(e)
            p.copy_(saved)
    return {"compared": compared, "control": control}


def case_train(args: dict) -> dict:
    """cli.train on this rank, once per argv of args['runs']: for each, its
    history, its final weights (gathered), its log directory, FSDP's
    unsharded tensors and, from one more forward, whether each AFNO module
    read its weights with the bf16 cache on, the count of replicated
    batches and the replica check (`replica_check`)."""
    import torch

    from dpot_tpu_torch.cli.train import main
    from dpot_tpu_torch.ops.cuda.afno_fused import PATHS, fused_gn_afno
    from dpot_tpu_torch.parallel import shard_rows
    from dpot_tpu_torch.parallel.fsdp import check_fsdp_shardings

    runs = []
    for argv in args["runs"]:
        shard_rows.fallbacks = 0
        fused_gn_afno.launches_by_path.update(dict.fromkeys(PATHS, 0))
        out = main(argv)
        state = out["state"]
        marks = None
        if state.sharded:
            with block_cache_marks(state.model) as marks, torch.no_grad():
                state.forward_module(torch.zeros(1, 16, 16, 6, 2))
        runs.append({
            "history": {k: out[k] for k in ("train_l2_step", "train_l2_full",
                                            "test_l2_steps", "test_l2_fulls")},
            "params": {k: v.detach().clone() for k, v in state.params_state_dict().items()},
            "step": state.step,
            "log_dir": out["log_dir"],
            "cache_blocks": marks,
            "unsharded": check_fsdp_shardings(state) if state.sharded else None,
            "fallbacks": shard_rows.fallbacks,
            "ddp": type(state.train_module).__name__,
            "launches": dict(fused_gn_afno.launches_by_path),
            "replicas": replica_check(state),
        })
    return {"runs": runs}


def case_step(args: dict) -> dict:
    """One train step of the tiny DPOT from the weights in args['sd'] on this
    rank's rows of the global batch in args['batch'] (external noise), in
    each layout of args['layouts']: the aux and the weights after it."""
    import torch

    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.parallel import make_mesh, rank_world, replicate, shard_rows
    from dpot_tpu_torch.parallel.fsdp import shard_state_fsdp
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import UNTRAINED, make_train_step

    rank, world = rank_world()
    sd = torch.load(args["sd"])
    batch = torch.load(args["batch"])
    rows = shard_rows(batch["x"].shape[0], rank, world)
    local = {k: v[:, rows] if k == "noise" else v[rows] for k, v in batch.items()}
    out = {}
    for layout in args["layouts"]:
        model = build_model("DPOT", device="cpu", **args["cfg"])
        model.load_state_dict(sd)
        opt = build_optimizer("adam", model.parameters(), args["lr"], grad_clip=args["clip"])
        state = TrainState.create(model, opt, seed=0)
        if layout == "ddp":
            state.train_module = replicate(model, UNTRAINED)
            state.rank, state.world = rank, world
        else:
            shard_state_fsdp(state, make_mesh(device="cpu"))
        state, aux = make_train_step(noise_scale=args["noise"])(state, local)
        out[layout] = {"aux": {k: float(v) for k, v in aux.items()},
                       "params": {k: v.detach().clone()
                                  for k, v in state.params_state_dict().items()}}
    return out


def case_cache_check(args: dict) -> dict:
    """A small bf16 DPOT whose mixer takes the bf16 Hopper kernel (two AFNO
    blocks of 128 channels at a 16x16 latent), under FSDP2 on args['device'],
    args['steps'] lamb steps and then args['control'] steps through a cache
    keyed on the weight tensor alone (stale on purpose). Per step: how many
    of the forward's weights the kernel read as bf16 blocks that differ
    from a fresh conversion of the weight FSDP2 gathered for the call; and
    whether each AFNO module's first forward read its weights with the
    cache on."""
    import torch

    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.ops.cuda import afno_fused
    from dpot_tpu_torch.parallel import rank_world
    from dpot_tpu_torch.parallel.fsdp import shard_state_fsdp
    from dpot_tpu_torch.parallel.mesh import make_mesh
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_train_step
    from dpot_tpu_torch.utils.device import resolve_device

    rank, world = rank_world()
    device = resolve_device(args["device"])
    model = build_model("DPOT", img_size=128, patch_size=8, in_channels=4, in_timesteps=6,
                        embed_dim=256, depth=2, n_blocks=2, modes=8, n_cls=1,
                        dtype=torch.bfloat16, remat=True, device=device, seed=0)
    state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 1e-3), 0)
    shard_state_fsdp(state, make_mesh(device=device))
    step_fn = make_train_step(noise_scale=1e-3, ones_mask=True)
    real, same, stale = afno_fused._bf16_blocks, [], {}

    def check(w, out, pairs=False):
        same.append(torch.equal(out, afno_fused._convert_blocks(w.detach(), pairs)))
        return out

    def spy(w, pairs=False):
        return check(w, real(w, pairs), pairs)

    def stale_spy(w, pairs=False):
        stale.setdefault(id(w), afno_fused._convert_blocks(w.detach(), pairs))
        return check(w, stale[id(w)], pairs)

    steps, first = [], None
    for i in range(args["steps"] + args["control"]):
        g = torch.Generator().manual_seed(i)
        x = torch.randn((4, 128, 128, 6, 4), generator=g)
        y = torch.randn((4, 128, 128, 1, 4), generator=g)
        n = 4 // world
        rows = slice(rank * n, (rank + 1) * n)
        batch = {"x": x[rows].to(device, torch.bfloat16), "y": y[rows].to(device),
                 "cls": torch.zeros(n, dtype=torch.long, device=device)}
        same.clear()
        afno_fused._bf16_blocks = stale_spy if i >= args["steps"] else spy
        try:
            with block_cache_marks(model) as marks:
                step_fn(state, batch)
        finally:
            afno_fused._bf16_blocks = real
        first = marks[:2] if first is None else first  # the first forward's
        steps.append(dict(calls=len(same), mismatched=same.count(False)))
    return {"steps": steps, "launches": dict(afno_fused.fused_gn_afno.launches_by_path),
            "cache_blocks": first}


def rank_batch(b: dict, state, mesh) -> dict:
    """This rank's part of a global batch (x, y, msk, cls and external noise
    (steps, B, ...)): its rows over 'data' and, where the model splits the
    grid over 'spatial', its H rows."""
    from dpot_tpu_torch.parallel import shard_rows

    rows = shard_rows(b["x"].shape[0], state.rank, state.world) or slice(None)
    out = {k: v[:, rows] if k == "noise" else v[rows] for k, v in b.items()}
    sp = getattr(state.model, "spatial", None)
    if sp is not None:
        n = b["x"].shape[1] // sp.size
        h = slice(sp.rank * n, (sp.rank + 1) * n)
        out = {k: v[:, :, h] if k == "noise" else v if k == "cls" else v[:, h]
               for k, v in out.items()}
    return out


def case_layout_step(args: dict) -> dict:
    """Train steps from the weights in args['sd'] on the global batches in
    args['batches'] (external noise, or none), in each layout of
    args['layouts'] (name, mesh axes, shard_params, pipe_microbatches,
    remat; the model family, its config, weights and batches where they
    are not args'; 'lp': the bf16 working copy; 'accum': grad_accum, a
    batch that does not divide taking one full step, as in the loop), placed
    as cli.train places them (train/loop.py place_state): per layout the
    aux of each step, the full weights after them (gathered in the
    reference layout, buffers included), the gradients of the last step's
    parameters that are not shards, the sharded leaves, the fused kernel's
    calls and whether the working copy is its master's cast."""
    import torch

    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
    from dpot_tpu_torch.parallel import make_mesh, rank_world, shard_rows
    from dpot_tpu_torch.parallel.fsdp import gathered
    from dpot_tpu_torch.train.loop import check_ported, model_mesh_kw, place_state
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState, _local
    from dpot_tpu_torch.train.step import make_train_step
    from dpot_tpu_torch.utils.config import TrainConfig

    out = {}
    for lay in args["layouts"]:
        axes = lay["mesh"]
        family = lay.get("model", "DPOT")
        sd = torch.load(lay["sd"] if "sd" in lay else args["sd"])
        batches = torch.load(lay["batches"] if "batches" in lay else args["batches"])
        mesh = make_mesh(device="cpu", **axes)
        cfg = TrainConfig(model=family, train_paths=["x"],
                          shard_params=lay.get("shard_params", "replicate"),
                          mesh_spatial=axes.get("spatial", 1), mesh_model=axes.get("model", 1),
                          mesh_pipe=axes.get("pipe", 1),
                          pipe_microbatches=lay.get("micro", 0))
        check_ported(cfg, rank_world()[1])
        model = build_model(family, device="cpu", remat=lay.get("remat", False),
                            **model_mesh_kw(cfg, mesh), **lay.get("cfg", args.get("cfg")))
        model.load_state_dict(sd)
        opt = build_optimizer("adam", model.parameters(), args["lr"], grad_clip=args["clip"])
        state = TrainState.create(model, opt, seed=0,
                                  param_working_dtype=torch.bfloat16 if lay.get("lp") else None)
        state.mesh = mesh
        place_state(state, cfg, torch.device("cpu"))
        model.eval()  # a BatchNorm's buffers stay as they are
        with torch.no_grad():
            pred = model(rank_batch(batches[0], state, mesh)["x"])
        accum = lay.get("accum", 1)
        noise = lay.get("noise", args["noise"])
        step, whole = (make_train_step(noise_scale=noise, grad_accum=accum),
                       make_train_step(noise_scale=noise))
        calls = fused_gn_afno.launches
        block_calls = []
        hooks = [blk.register_forward_pre_hook(lambda *_: block_calls.append(1))
                 for blk in getattr(model, "blocks", ())]
        auxes = []
        for b in batches:
            n = b["x"].shape[0]
            fn = whole if n % accum else step
            replicated = state.world > 1 and shard_rows(n, state.rank, state.world) is None
            state, aux = fn(state, rank_batch(b, state, mesh), replicated=replicated)
            auxes.append({k: float(v) for k, v in aux.items()})
        for h in hooks:
            h.remove()
        lp_cast = None
        if state.params_lp is not None:
            lp_cast = all(torch.equal(p, m.to(p.dtype)) for p, m in
                          zip(_local(state.params_lp), _local(state.optimizer.params)))
        out[lay["name"]] = {
            "forward": [t.detach() for t in pred] if isinstance(pred, tuple) else [pred],
            "block_calls": len(block_calls), "aux": auxes,
            "params": {k: v.detach().clone() for k, v in state.params_state_dict().items()},
            "grads": {n: gathered(p.grad).detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None and n not in getattr(model, "tp_dims", {})},
            "local_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "tp_dims": dict(getattr(model, "tp_dims", {})), "world": state.world,
            "calls": fused_gn_afno.launches - calls, "lp_cast": lp_cast,
            "sharded": state.sharded,
        }
    return out


def case_serve(args: dict) -> dict:
    """Serving over a mesh: every rank builds the tiny DPOT from args['sd']
    (over the mesh's 'pipe' or 'spatial' axis where it has one) and a
    RolloutServer over the mesh args['mesh'] (by default 'model' over all
    ranks); rank 0 answers the requests args['requests'] ((x, steps) pairs
    from args['xs']), the others follow until it stops. Rank 0's answers
    and counters."""
    import torch

    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.parallel import make_mesh, rank_world
    from dpot_tpu_torch.serve.server import RolloutServer
    from dpot_tpu_torch.train.loop import model_mesh_kw
    from dpot_tpu_torch.utils.config import TrainConfig

    axes = args.get("mesh") or dict(model=rank_world()[1])
    mesh = make_mesh(device="cpu", **axes)
    cfg = TrainConfig(train_paths=["x"], mesh_pipe=axes.get("pipe", 1),
                      mesh_spatial=axes.get("spatial", 1))
    model = build_model("DPOT", device="cpu", **model_mesh_kw(cfg, mesh), **args["cfg"])
    model.load_state_dict(torch.load(args["sd"]))
    rs = RolloutServer(model, mesh=mesh, device="cpu", batch_buckets=(1, 2), max_wait_ms=1.0)
    xs = torch.load(args["xs"])
    rs.start()
    shards = dict(shards=len(getattr(model, "tp_dims", {})), blocks=len(model.blocks))
    if not rs.leader:
        return {"preds": None, **shards}
    preds = [rs.submit(xs[i].numpy(), steps) for i, steps in args["requests"]]
    rs.stop(drain=True)
    return {"preds": preds, "metrics": rs.metrics(), "n_params": rs.n_params, **shards}


def case_serve_cli(args: dict) -> dict:
    """cli.serve under torchrun (args['argv'], its mesh from the --mesh_*
    flags): rank 0 listens and answers the request (args['xs'][0] at
    args['steps'] steps) in-process, then stops; the others follow until
    then. Rank 0's answer."""
    import torch

    from dpot_tpu_torch.cli.serve import main

    httpd, rs = main(args["argv"], wait=False)
    if httpd is None:  # a follower, back once rank 0 stopped
        return {"pred": None, "blocks": len(rs.model.blocks)}
    pred = rs.submit(torch.load(args["xs"])[0].numpy(), args["steps"])
    rs.stop(drain=True)
    httpd.shutdown()
    return {"pred": pred, "blocks": len(rs.model.blocks)}


def case_fsdp_ckpt(args: dict) -> dict:
    """FSDP2 checkpoints gathered without DTensor's full_tensor (made to
    raise here): cli.train's runs of args['runs'] (case_train), the first
    writing a checkpoint; that checkpoint restored into a fresh state of
    the tiny DPOT (args['cfg']) placed under FSDP2, whose gathered weights
    and moments come back (bit for bit the file's, if the gather is
    right); then cli.train on args['resume'] resuming from it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dpot_tpu_torch.cli.train import main
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.parallel import make_mesh
    from dpot_tpu_torch.parallel.fsdp import shard_state_fsdp
    from dpot_tpu_torch.train.checkpoint import restore_checkpoint
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState

    def refused(self, *a, **k):
        raise AssertionError("DTensor.full_tensor called")

    DTensor.full_tensor = refused
    out = case_train(args)
    path = [out["runs"][0]["log_dir"]]
    dist.broadcast_object_list(path, src=0)  # rank 0 wrote it, then got here
    ckpt = f"{path[0]}/model"
    model = build_model("DPOT", device="cpu", **args["cfg"])
    state = TrainState.create(model, build_optimizer("lamb", model.parameters(), 1e-3), 0)
    restore_checkpoint(ckpt, state)
    shard_state_fsdp(state, make_mesh(device="cpu"))
    mu, nu = state.full_moments()
    out["restored"] = dict(params=state.params_state_dict(), mu=mu, nu=nu, step=state.step,
                           local=[tuple(p.to_local().shape) for p in model.parameters()])
    out["resumed"] = case_train({"runs": [args["resume"] + ["--resume_path", ckpt]]})["runs"][0]
    return out


def case_mixer(args: dict) -> dict:
    """The pencil-FFT mixer (parallel/dist_fft.py) on this rank's rows of the
    global x in args['inputs'] for each case (modes, compute dtype): the
    output rows and, in float32, the gradients of sum(y * r) (r from the
    file) with respect to this rank's x rows and to the weights."""
    import torch

    from dpot_tpu_torch.ops.activations import get_activation
    from dpot_tpu_torch.parallel import make_mesh, rank_world
    from dpot_tpu_torch.parallel.dist_fft import afno_filter_2d_sharded

    _, world = rank_world()
    axis = make_mesh(spatial=world, device="cpu").axis("spatial")
    inp = torch.load(args["inputs"])
    n = inp["x"].shape[1] // world
    rows = slice(axis.rank * n, (axis.rank + 1) * n)
    out = {}
    for modes, dtype in args["cases"]:
        x = inp["x"][:, rows].clone().requires_grad_(dtype == "float32")
        ws = [w.clone().requires_grad_(dtype == "float32") for w in inp["weights"]]
        cd = getattr(torch, dtype)
        y = afno_filter_2d_sharded(x, *ws, modes, get_activation("gelu"), axis,
                                   compute_dtype=cd)
        res = {"y": y.detach()}
        if dtype == "float32":
            (y * inp["r"][:, rows]).sum().backward()
            res["dx"] = x.grad
            res["dw"] = [w.grad for w in ws]
        out[f"{modes}/{dtype}"] = res
    return out


def case_suite(args: dict) -> dict:
    """Several cases in one launch: args['suite'] holds (key, case, args)
    triples; their results by key."""
    return {key: CASES[case](sub) for key, case, sub in args["suite"]}


CASES = {"train": case_train, "step": case_step, "cache_check": case_cache_check,
         "layout_step": case_layout_step, "serve": case_serve, "mixer": case_mixer,
         "fsdp_ckpt": case_fsdp_ckpt, "serve_cli": case_serve_cli, "suite": case_suite}


def main() -> None:
    case, out_dir, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from dpot_tpu_torch.data.registry import make_synthetic_spec
    from dpot_tpu_torch.parallel import maybe_initialize

    torch.set_num_threads(1)
    torch.backends.cudnn.deterministic = bool(args.get("cudnn_deterministic"))
    for name, kw in args.get("specs", {}).items():
        make_synthetic_spec(name, **kw)
    if not maybe_initialize(args.get("backend", "gloo"), timeout=60):
        raise RuntimeError("torchrun's variables are not set")
    result = CASES[case](args)
    torch.save(result, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
