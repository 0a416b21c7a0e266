"""Command-line entry points of the port (counterparts of
``visualdet3d_tpu/cli/``): ``python -m visualdet3d_tpu_torch.cli.<name>``."""
