"""Bilinear sampling, NHWC (counterpart of ``visualdet3d_tpu/ops/sampling.py``).

The JAX package samples with four gathers and two lerps; here both
functions are ``torch.nn.functional.grid_sample`` (bilinear) on a
channels_last view of the image, which computes the same values and the
same gradients with respect to the image and the grid:

* ``'zeros'``: each corner outside the image contributes 0 on its own, a
  sample straddling the border keeping its corners inside (JAX zeroes each
  corner with ``where``; torch skips it);
* ``'border'``: torch clamps the sample coordinate into the image before
  the lerp, JAX clamps the corner indices after ``floor``. Both give the
  border row's (column's) value past an edge, where the gradient with
  respect to the grid is 0 in both; inside they compute the same lerp.

The lerp weights are multiplied out in a different order (torch forms the
four corner weights, JAX lerps along x, then y), a last-bit difference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PADDING_MODES = ('border', 'zeros')


def _check_padding(padding_mode: str) -> None:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f'padding_mode {padding_mode!r}: one of {PADDING_MODES}')


def grid_sample(images: torch.Tensor, grid: torch.Tensor, padding_mode: str = 'border',
                align_corners: bool = True) -> torch.Tensor:
    """Batched bilinear sampling at normalised coordinates.

    Args:
      images: [B, H, W, C].
      grid: [B, Ho, Wo, 2], (x, y) in [-1, 1]; with ``align_corners`` -1
        and 1 are the centres of the corner pixels, else their outer edges.
      padding_mode: 'border' | 'zeros'.
    Returns:
      [B, Ho, Wo, C] in the images' dtype (the grid is cast to it).
    """
    _check_padding(padding_mode)
    out = F.grid_sample(images.permute(0, 3, 1, 2), grid.to(images.dtype), mode='bilinear',
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor,
                   padding_mode: str = 'border') -> torch.Tensor:
    """Bilinear sampling of one image at pixel coordinates.

    Args:
      image: [H, W, C].
      coords: [..., 2], (x, y) in pixels (0 is the first pixel's centre).
      padding_mode: 'border' | 'zeros'.
    Returns:
      [..., C].
    """
    _check_padding(padding_mode)
    h, w = image.shape[0], image.shape[1]
    # pixels -> normalised coordinates under align_corners=False, whose
    # mapping ((g + 1) * size - 1) / 2 holds for an axis of one pixel too
    size = torch.tensor([w, h], dtype=coords.dtype, device=coords.device)
    grid = (2.0 * coords + 1.0) / size - 1.0
    out = F.grid_sample(image.permute(2, 0, 1)[None], grid.reshape(1, 1, -1, 2).to(image.dtype),
                        mode='bilinear', padding_mode=padding_mode, align_corners=False)
    return out[0, :, 0].transpose(0, 1).reshape(*coords.shape[:-1], image.shape[2])
