"""Logging and timing helpers."""
from visualdet3d_tpu_torch.utils.logger import AverageMeter, LossLogger, MetricWriter  # noqa: F401
from visualdet3d_tpu_torch.utils.timer import Timer, formatting_time  # noqa: F401
