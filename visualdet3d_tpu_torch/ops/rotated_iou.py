"""Rotated-box IoU and 3-D IoU, branch-free (counterpart of
``visualdet3d_tpu/ops/rotated_iou.py``): Sutherland-Hodgman clipping of
convex quads as masked arithmetic over fixed 8-vertex buffers with
cumsum compaction, written for a batch of box pairs (the JAX package
``vmap``s a per-pair function). Forward only: the one training caller,
``position_loss``, stops the gradient through the IoU.

Box conventions:
  rotated rect: [cx, cy, w, h, angle]: w along local x, h along local y,
  angle counter-clockwise (radians).
  camera-frame 3-D box: [x, y, z, w, h, l, theta] with y the *bottom*
  center (KITTI), h vertical; the BEV rect is (x, z, l, w, theta).
"""
from __future__ import annotations

import torch

_MAX_V = 8  # a convex quad clipped by 4 half-planes has <= 8 vertices


def rect_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, w, h, angle) -> [..., 4, 2] CCW corners."""
    cx, cy, w, h, ang = (boxes[..., i] for i in range(5))
    cos, sin = torch.cos(ang), torch.sin(ang)
    lx = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    ly = torch.stack([-h, -h, h, h], dim=-1) * 0.5
    gx = cx[..., None] + (lx * cos[..., None] - ly * sin[..., None])
    gy = cy[..., None] + (lx * sin[..., None] + ly * cos[..., None])
    return torch.stack([gx, gy], dim=-1)


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _next_index(n: torch.Tensor) -> torch.Tensor:
    """[N, MAX_V]: the index of each vertex's successor in a polygon of n."""
    idx = torch.arange(_MAX_V, device=n.device)
    # the clamp is the JAX package's out-of-range gather (n <= MAX_V here)
    return torch.where(idx + 1 >= n[:, None], 0, idx + 1).clamp(max=_MAX_V - 1)


def _shoelace(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Signed area of the first n vertices of each poly [N, MAX_V, 2]."""
    valid = torch.arange(_MAX_V, device=n.device) < n[:, None]
    nxt = _next_index(n)
    x, y = poly[..., 0], poly[..., 1]
    terms = x * y.gather(1, nxt) - x.gather(1, nxt) * y
    return 0.5 * torch.where(valid, terms, 0.0).sum(dim=1)


def _clip_halfplane(poly: torch.Tensor, n: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                    orient: torch.Tensor):
    """Clip each polygon (poly[:, :n]) against the half-plane on side
    ``orient`` of p1 -> p2. poly [N, MAX_V, 2], n [N], p1/p2 [N, 2],
    orient [N]. Returns (new_poly [N, MAX_V, 2], new_n [N]): up to 2
    candidate vertices per input vertex, compacted by cumsum positions."""
    num = poly.shape[0]
    valid = torch.arange(_MAX_V, device=n.device) < n[:, None]
    cur = poly
    nxt = poly.gather(1, _next_index(n)[..., None].expand(-1, -1, 2))

    d = p2 - p1
    f_cur = d[:, None, 0] * (cur[..., 1] - p1[:, None, 1]) - d[:, None, 1] * (cur[..., 0] - p1[:, None, 0])
    f_nxt = d[:, None, 0] * (nxt[..., 1] - p1[:, None, 1]) - d[:, None, 1] * (nxt[..., 0] - p1[:, None, 0])
    f_cur = f_cur * orient[:, None]
    f_nxt = f_nxt * orient[:, None]
    in_cur = f_cur >= 0
    in_nxt = f_nxt >= 0

    denom = f_cur - f_nxt
    t = torch.where(denom.abs() > 1e-12, f_cur / torch.where(denom == 0, 1.0, denom), 0.0)
    inter = cur + t[..., None] * (nxt - cur)

    # candidate stream preserving order: [v0, i0, v1, i1, ...]
    cand = torch.stack([cur, inter], dim=2).reshape(num, 2 * _MAX_V, 2)
    keep = torch.stack([valid & in_cur, valid & (in_cur != in_nxt)], dim=2).reshape(num, -1)
    pos = torch.cumsum(keep.long(), dim=1) - 1
    pos = torch.where(keep, pos, 2 * _MAX_V)  # dropped: the spare last row
    # positions past MAX_V - 1 are dropped, as by mode='drop' in the JAX op
    new_poly = poly.new_zeros((num, 2 * _MAX_V + 1, 2))
    new_poly.scatter_(1, pos[..., None].expand(-1, -1, 2), cand)
    return new_poly[:, :_MAX_V], keep.sum(dim=1)


def _pair_intersection_area(corners_a: torch.Tensor, corners_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of aligned pairs of convex quads [N, 4, 2] -> [N]."""
    num = corners_a.shape[0]
    poly = corners_a.new_zeros((num, _MAX_V, 2))
    poly[:, :4] = corners_a
    n = torch.full((num,), 4, dtype=torch.long, device=corners_a.device)
    # orientation of b (either chirality)
    area_b2 = (_cross(corners_b[:, 0], corners_b[:, 1], corners_b[:, 2])
               + _cross(corners_b[:, 0], corners_b[:, 2], corners_b[:, 3]))
    orient = torch.where(area_b2 >= 0, 1.0, -1.0).to(corners_a.dtype)
    for i in range(4):
        poly, n = _clip_halfplane(poly, n, corners_b[:, i], corners_b[:, (i + 1) % 4], orient)
    return _shoelace(poly, n).abs()


def _pairwise(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """Every (a, b) pair as two aligned [N*M, D] batches."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    return (boxes_a[:, None].expand(n, m, -1).reshape(n * m, -1),
            boxes_b[None].expand(n, m, -1).reshape(n * m, -1))


def rotated_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of rotated rects. boxes_a [N, 5], boxes_b [M, 5] -> [N, M]."""
    a, b = _pairwise(boxes_a, boxes_b)
    inter = _pair_intersection_area(rect_corners(a), rect_corners(b))
    union = (a[:, 2] * a[:, 3]).abs() + (b[:, 2] * b[:, 3]).abs() - inter
    return (inter / union.clamp(min=1e-8)).reshape(boxes_a.shape[0], boxes_b.shape[0])


def camera_box_to_bev(boxes7: torch.Tensor) -> torch.Tensor:
    """[N, 7] (x, y, z, w, h, l, theta) camera boxes -> [N, 5] BEV rects."""
    return torch.stack([boxes7[:, 0], boxes7[:, 2], boxes7[:, 5], boxes7[:, 3], boxes7[:, 6]],
                       dim=-1)


def aligned_boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3-D IoU of aligned pairs of camera-frame boxes [N, 7], [N, 7] -> [N].
    y is the bottom center (KITTI), so the vertical span is [y - h, y]."""
    inter_bev = _pair_intersection_area(rect_corners(camera_box_to_bev(boxes_a)),
                                        rect_corners(camera_box_to_bev(boxes_b)))
    inter_h = (torch.minimum(boxes_a[:, 1], boxes_b[:, 1])
               - torch.maximum(boxes_a[:, 1] - boxes_a[:, 4], boxes_b[:, 1] - boxes_b[:, 4])
               ).clamp(min=0)
    inter_vol = inter_bev * inter_h
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    union = vol_a + vol_b - inter_vol
    return inter_vol / union.clamp(min=1e-8)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise 3-D IoU of camera-frame boxes [N, 7] x [M, 7] -> [N, M]."""
    a, b = _pairwise(boxes_a, boxes_b)
    return aligned_boxes_iou3d(a, b).reshape(boxes_a.shape[0], boxes_b.shape[0])
