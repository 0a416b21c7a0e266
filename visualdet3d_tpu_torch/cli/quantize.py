"""Write a reusable int8 inference artifact from a trained checkpoint
(counterpart of ``visualdet3d_tpu/cli/quantize.py``), on the card unless
``--device`` names another.

Loads the latest checkpoint of ``--checkpoint_path``, folds BN, calibrates
the activation scales on frames of the training split and quantizes
(``pipelines/inference_prep.quantize_on_training_frames``, the function the
eval CLI calibrates with), and saves the folded network and its int8
entries with ``checkpoint.save_params``. ``cli/eval.py --quantized_path``
then runs int8 without calibrating, with the same result as calibrating on
the fly.

Usage:
  python -m visualdet3d_tpu_torch.cli.quantize --config=configs/stereo3d_int8.py \\
      --checkpoint_path=workdirs/Stereo3D/checkpoint --output_path=workdirs/Stereo3D/int8.pt
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Quantize a checkpoint of the PyTorch port.')
    parser.add_argument('--config', default='configs/stereo3d_int8.py')
    parser.add_argument('--checkpoint_path', required=True)
    parser.add_argument('--output_path', required=True, help='the artifact file to write')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; cpu runs the plain paths)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from visualdet3d_tpu_torch.checkpoint import save_params
    from visualdet3d_tpu_torch.cli.eval import load_system
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.device import resolve_device
    from visualdet3d_tpu_torch.pipelines.inference_prep import (int8_artifact,
                                                                quantize_on_training_frames)

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.config)
    system = load_system(cfg, args.checkpoint_path, device)
    quant = quantize_on_training_frames(cfg, system)
    path = save_params(args.output_path, int8_artifact(system))
    print(f'saved the int8 artifact ({len(quant)} quant entries) to {path}')


if __name__ == '__main__':
    main()
