"""Shape and model inspection (port of dpot_tpu/utils/inspection.py, the
counterparts of the reference's torch_utils/misc.py helpers): `assert_shape`
(:99), `module_summary` (print_module_summary, :213),
`check_replica_consistency` (check_ddp_consistency, :197) and
`save_results` (utils/utilities.py save_results_excel, as CSV)."""

from __future__ import annotations

import csv
from typing import Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Raise AssertionError unless x's shape is `ref_shape`; None entries
    match any size."""
    shape = tuple(x.shape)
    if len(shape) != len(ref_shape):
        raise AssertionError(f"wrong rank: got {len(shape)}, expected {len(ref_shape)}")
    for i, (got, want) in enumerate(zip(shape, ref_shape)):
        if want is not None and got != want:
            raise AssertionError(f"wrong size for dim {i}: got {got}, expected {want}")


def _named(tensors) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) pairs of a module's parameters, a mapping, or an
    iterable of tensors (named by position)."""
    if isinstance(tensors, torch.nn.Module):
        return list(tensors.named_parameters())
    if isinstance(tensors, Mapping):
        return list(tensors.items())
    return [(str(i), t) for i, t in enumerate(tensors)]


def module_summary(params: torch.nn.Module | Mapping | Iterable, max_rows: int = 200) -> str:
    """A table of parameters: name, shape, count, and the total over all of
    them (the rows past `max_rows` counted, not listed)."""
    named = _named(params)
    lines = [f"{'parameter':60s} {'shape':>20s} {'count':>12s}"]
    for name, t in named[:max_rows]:
        lines.append(f"{name:60s} {str(tuple(t.shape)):>20s} {t.numel():>12,d}")
    if len(named) > max_rows:
        lines.append(f"... ({len(named) - max_rows} more)")
    total = sum(t.numel() for _, t in named)
    lines.append(f"{'TOTAL':60s} {'':>20s} {total:>12,d}")
    return "\n".join(lines)


def _replicated(name: str, t: torch.Tensor, tp_dims: Mapping) -> Optional[torch.Tensor]:
    """The local tensor that the ranks should hold alike, or None for a
    shard: an FSDP2 DTensor sharded over its mesh, or a tensor-parallel
    shard (a name in the model's `tp_dims`)."""
    if name in tp_dims:
        return None
    if isinstance(t, DTensor):
        if not all(p.is_replicate() for p in t.placements):
            return None
        t = t.to_local()
    return t.detach()


def check_replica_consistency(module_or_tensors, atol: float = 0.0, group=None) -> int:
    """Raise AssertionError on every rank of `group` (default: the default
    group) unless each replicated tensor, a module's parameters and buffers
    or the given tensors, holds the same values on all its ranks: bit for
    bit at atol 0 (the reference compares exactly), else within atol.
    Shards are skipped, as JAX skips shards of different indices: FSDP2's
    local shards and tensor-parallel shards. The ranks of `group` must hold
    the same tensors (a 'data' axis: DDP's replicas, a layout's replicated
    tails). Returns the number of tensors compared; one process compares
    none. A collective: every rank of `group` calls it."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tp_dims = getattr(module_or_tensors, "tp_dims", None) or {}
        named = (list(module_or_tensors.named_parameters())
                 + list(module_or_tensors.named_buffers()))
    else:
        tp_dims, named = {}, _named(module_or_tensors)
    if not dist.is_initialized() or dist.get_world_size(group) < 2:
        return 0
    named = [(n, r) for n, t in named if (r := _replicated(n, t, tp_dims)) is not None]
    if not named:
        return 0
    device = named[0][1].device
    # the tensors' bytes, broadcast from the group's first rank in one call
    local = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for _, t in named])
    sizes = torch.tensor([local.numel(), -local.numel()], device=device)
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
    if sizes[0] != -sizes[1]:
        raise AssertionError("replica mismatch: the ranks hold tensors of different sizes")
    ref = local.clone()
    dist.broadcast(ref, src=dist.get_global_rank(group, 0) if group is not None else 0,
                   group=group)
    bad = torch.zeros(len(named), dtype=torch.int32, device=device)
    start = 0
    for i, (_, t) in enumerate(named):
        n = t.numel() * t.element_size()
        mine, theirs = local[start:start + n], ref[start:start + n]
        start += n
        if atol == 0.0:
            same = torch.equal(mine, theirs)
        else:
            a, b = mine.view(t.dtype).float(), theirs.view(t.dtype).float()
            same = bool(((a - b).abs() <= atol).all())
        bad[i] = int(not same)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
    if bad.any():
        names = [n for (n, _), b in zip(named, bad.tolist()) if b]
        raise AssertionError(f"replica mismatch at {names[0]}"
                             + (f" and {len(names) - 1} more" if len(names) > 1 else ""))
    return len(named)


def save_results(path: str, rows: list[dict]) -> None:
    """One CSV row per record, the columns the sorted union of the keys."""
    if not rows:
        return
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
