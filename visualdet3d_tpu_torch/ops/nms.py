"""Fixed-capacity greedy NMS on tensors (counterpart of
``visualdet3d_tpu/ops/nms.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from visualdet3d_tpu_torch.geometry import calc_iou


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


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_outputs: int = 256, pre_top_k: int = 1024,
        valid_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned greedy NMS with a fixed output size, batched over any
    leading dimensions.

    Args:
      boxes: [..., N, 4] (x1, y1, x2, y2).
      scores: [..., N].
      iou_threshold: suppress a box whose IoU with a kept higher one is
        above this.
      max_outputs: K_out, the number of kept indices returned.
      pre_top_k: candidates entering the O(K^2) suppression stage.
      valid_mask: optional [..., N] bool; False entries are never selected.
    Returns:
      keep_indices [..., K_out] int32 into the input (-1 padding) and
      keep_valid [..., K_out] bool.

    Candidates are taken in descending score order with the lower index
    first among ties, and survivors keep that order: a stable sort, as
    ``jax.lax.top_k`` and ``jnp.argsort`` order them.
    """
    n = boxes.shape[-2]
    k = min(pre_top_k, n)
    neg_inf = torch.finfo(scores.dtype).min
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, neg_inf)
    top_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, order = top_scores[..., :k], order[..., :k]
    cand_valid = top_scores > neg_inf
    cand_boxes = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    keep = _greedy_suppress(calc_iou(cand_boxes, cand_boxes), cand_valid, iou_threshold)

    # survivors by their (already sorted) rank, the first K_out of them
    rank = torch.arange(k, device=boxes.device).expand_as(keep)
    kept_rank = torch.where(keep, rank, k)
    sel = torch.sort(kept_rank, dim=-1, stable=True).indices[..., :max_outputs]
    sel_valid = keep.gather(-1, sel)
    keep_indices = torch.where(sel_valid, order.gather(-1, sel), -1)
    return keep_indices.to(torch.int32), sel_valid
