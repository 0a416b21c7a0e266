"""Host-side (numpy) box utilities of the test-time post-optimisation
(counterpart of ``visualdet3d_tpu/models/fast_utils``)."""
from visualdet3d_tpu_torch.models.fast_utils.bbox2d import bbox2d_area, iou_2d
from visualdet3d_tpu_torch.models.fast_utils.bbox3d import project_3d_corners
from visualdet3d_tpu_torch.models.fast_utils.hill_climbing import (
    post_opt,
    post_optimization,
)
