"""Evaluate a trained checkpoint on a KITTI split (counterpart of
``visualdet3d_tpu/cli/eval.py``; reference scripts/eval.py:14-55), on the
card unless ``--device`` names another.

Loads the latest checkpoint of ``--checkpoint_path`` (the train CLI's, or
any ``checkpoint_<step>.pt`` holding a ``model`` state_dict; Stereo3D's
train-only disparity head is left out), applies
``detector.inference_dtype`` (``pipelines/inference_prep.py``: f32, bf16,
or int8 calibrated on training frames or loaded from ``--quantized_path``),
then runs the config's ``evaluate_func`` (``evaluate_kitti_obj``): the
config's tester frame by frame at batch 1, a KITTI result txt a frame in
the original camera, and the KITTI object evaluator's AP table. Appends one
JSON line to ``<log_path>/eval_stats.jsonl``: the split, frames, the ms of
each frame's item, inference and post-optimisation, the evaluator's
seconds, the kernel launches and the set-up seconds.

Usage:
  python -m visualdet3d_tpu_torch.cli.eval --config=configs/stereo3d.py \\
      --checkpoint_path=workdirs/Stereo3D/checkpoint --split_to_test=validation \\
      [--quantized_path=workdirs/Stereo3D/int8.pt] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Evaluate a checkpoint of the PyTorch port.')
    parser.add_argument('--config', default='configs/stereo3d.py')
    parser.add_argument('--checkpoint_path', required=True)
    parser.add_argument('--split_to_test', default='validation',
                        choices=('training', 'validation', 'test'))
    parser.add_argument('--quantized_path', default=None,
                        help='an int8 artifact of cli/quantize.py (skips the calibration)')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; cpu runs the plain paths)')
    return parser.parse_args(argv)


def load_system(cfg, checkpoint_path: str, device):
    """The config's detector on ``device`` with the latest checkpoint of
    ``checkpoint_path`` loaded (an inference network: the train-only
    modules of the checkpoint are left out)."""
    from visualdet3d_tpu_torch.checkpoint import CheckpointManager, load_model_weights
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers the detectors)
    if not os.path.isdir(checkpoint_path):
        raise FileNotFoundError(f'no checkpoint directory {checkpoint_path}')
    saved = CheckpointManager(checkpoint_path).restore()
    if saved is None:
        raise FileNotFoundError(f'no checkpoint_<step>.pt in {checkpoint_path}')
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device=device)
    load_model_weights(system.net, saved['model'], system.bridge_skip())
    system.weights_changed()
    return system


def dataset_of(cfg, split: str):
    """The dataset a split is evaluated on: the train dataset for
    'training', the test dataset (no labels; ``is_running_test_set``) for
    'test', else the validation dataset."""
    from visualdet3d_tpu_torch.registry import DATASET_DICT
    import visualdet3d_tpu_torch.data  # noqa: F401  (registers the datasets)
    if split == 'training':
        name = cfg.data.train_dataset
    elif split == 'test':
        name = cfg.data.test_dataset
        cfg.is_running_test_set = True
    else:
        name = cfg.data.val_dataset
    return DATASET_DICT[name](cfg, split)


def main(argv=None):
    t_main = time.perf_counter()
    args = parse_args(argv)
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.device import resolve_device
    from visualdet3d_tpu_torch.ops import launch_counts
    from visualdet3d_tpu_torch.pipelines import evaluators, testers  # noqa: F401  (registers)
    from visualdet3d_tpu_torch.pipelines.inference_prep import prepare_inference_variables
    from visualdet3d_tpu_torch.registry import PIPELINE_DICT

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.config)
    evaluate = PIPELINE_DICT[cfg.trainer.evaluate_func]
    dataset = dataset_of(cfg, args.split_to_test)
    system = load_system(cfg, args.checkpoint_path, device)
    prepare_inference_variables(cfg, system, quantized_path=args.quantized_path)

    stats = {}
    before = launch_counts()
    setup_s = time.perf_counter() - t_main
    evaluate(cfg, system, dataset, None, 0, result_path_split=args.split_to_test, stats=stats)
    after = launch_counts()
    evaluators.write_eval_stats(cfg, dict(
        split=args.split_to_test, frames=len(dataset), device=str(device),
        inference_dtype=cfg.detector.get('inference_dtype', 'float32'),
        quantized_path=args.quantized_path, setup_s=setup_s, **stats,
        launches={k: after[k] - before[k] for k in after if after[k] != before[k]}))
    print('finish')


if __name__ == '__main__':
    main()
