"""Training steps (counterpart of ``visualdet3d_tpu/pipelines``)."""
