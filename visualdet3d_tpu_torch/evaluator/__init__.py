"""The offline KITTI evaluators (counterpart of ``visualdet3d_tpu/evaluator``):
``kitti_object`` (the object benchmark's 40-point AP) and ``kitti_depth``
(the depth-prediction errors). ``python -m visualdet3d_tpu_torch.evaluator``
runs either on files."""
