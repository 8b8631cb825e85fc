"""Training losses (port of dpot_tpu/utils/criterion.py: `rel_lp_loss` and
`cross_entropy_sum`). The evaluator's metric battery waits for the evaluate
CLI (ROADMAP, 'Modules to port', item 9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_lp_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    p: int = 2,
    reduce_batch: bool = True,
) -> torch.Tensor:
    """Per-channel relative Lp norm over flattened space-time, masked, summed
    over channels, divided by the count of channels with a non-zero mask,
    summed over the batch (the reference's SimpleLpLoss, size_average=False).
    pred/target: (B, ..., C); mask broadcastable to them (the data layer
    gives (B, H, W, 1, C)). reduce_batch=False returns the per-sample
    vector."""
    B, C = pred.shape[0], pred.shape[-1]
    if mask is not None:
        x, y = pred * mask, target * mask
        # channels with any non-zero mask weight
        msk_channels = torch.count_nonzero(
            mask.sum(dim=tuple(range(1, mask.dim() - 1))), dim=-1
        ).to(x.dtype)
    else:
        x, y = pred, target
        msk_channels = torch.full((B,), C, dtype=torch.result_type(pred, target),
                                  device=pred.device)
    xf = x.reshape(B, -1, C)
    yf = y.reshape(B, -1, C)
    if p == 2:
        diff_norms = (xf - yf).square().sum(dim=1).sqrt()
        y_norms = yf.square().sum(dim=1).sqrt() + 1e-8
    else:
        diff_norms = (xf - yf).abs().pow(p).sum(dim=1).pow(1.0 / p)
        y_norms = yf.abs().pow(p).sum(dim=1).pow(1.0 / p) + 1e-8
    per_sample = (diff_norms / y_norms).sum(dim=-1) / msk_channels
    return per_sample.sum() if reduce_batch else per_sample


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss(reduction='sum') on (B, n_cls) logits and (B,)
    integer labels (the reference's dataset classifier loss)."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="sum")
