"""Fixed-capacity greedy NMS on tensors (counterpart of
``visualdet3d_tpu/ops/nms.py``)."""
from __future__ import annotations

import torch


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy suppression over score-descending candidates, batched.

    Greedy NMS is the unique fixpoint of
        kept[j] = valid[j] and not any(i < j, kept[i], iou[i, j] > thr);
    Jacobi iteration of this recurrence settles every box whose suppression
    chain is shorter than the iteration count, so iterating until no item
    changes (at most K times) is exact. Each iteration is one masked
    [B, 1, K] x [B, K, K] product; extra iterations at a fixpoint are
    harmless.

    Args:
      iou: [..., K, K] pairwise IoU of the ordered candidates.
      valid: [..., K] bool; False entries are pre-suppressed (padding).
      iou_threshold: suppress j if iou(i, j) > threshold for a kept i < j.
    Returns:
      keep: [..., K] bool mask of survivors.
    """
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    suppress = ((iou > iou_threshold) & (idx[:, None] < idx[None, :])).to(torch.float32)
    kept = valid
    for _ in range(k):
        hit = (kept.to(torch.float32).unsqueeze(-2) @ suppress).squeeze(-2) > 0
        new = valid & ~hit
        if torch.equal(new, kept):
            break
        kept = new
    return kept
