"""Host-side data: KITTI I/O, augmentations, datasets, samplers and the
loader. Importing this package registers the datasets, augmentations and
samplers."""
from visualdet3d_tpu_torch.data import augmentations as _augmentations  # noqa: F401
from visualdet3d_tpu_torch.data import samplers as _samplers  # noqa: F401
from visualdet3d_tpu_torch.data.kitti.dataset import depth_dataset as _depth  # noqa: F401
from visualdet3d_tpu_torch.data.kitti.dataset import km3d_dataset as _km3d  # noqa: F401
from visualdet3d_tpu_torch.data.kitti.dataset import mono_dataset as _mono  # noqa: F401
from visualdet3d_tpu_torch.data.kitti.dataset import stereo_dataset as _stereo  # noqa: F401
from visualdet3d_tpu_torch.data.loader import DataLoader, build_dataloader  # noqa: F401
