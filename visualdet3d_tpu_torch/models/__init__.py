"""Importing this package registers the ported detectors and backbones."""
from visualdet3d_tpu_torch.models.backbones import dla as _dla  # noqa: F401
from visualdet3d_tpu_torch.models.backbones import resnet as _resnet  # noqa: F401
from visualdet3d_tpu_torch.models.detectors import km3d as _km3d  # noqa: F401
from visualdet3d_tpu_torch.models.detectors import monodepth as _monodepth  # noqa: F401
from visualdet3d_tpu_torch.models.detectors import retinanet as _retinanet  # noqa: F401
from visualdet3d_tpu_torch.models.detectors import yolo3d as _yolo3d  # noqa: F401
from visualdet3d_tpu_torch.models.detectors import yolostereo3d as _yolostereo3d  # noqa: F401
