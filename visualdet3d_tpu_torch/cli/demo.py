"""Run a trained detector on one KITTI frame and draw its detections
(counterpart of the JAX package's ``tools/demo.py``), on the card unless
``--device`` names another.

Loads the latest checkpoint of ``--checkpoint_path`` as the eval CLI does
(``cli/eval.py``: ``load_system``, ``prepare_inference_variables``), runs
the config's tester on frame ``--index`` of ``--split`` at batch 1, and
draws on the de-normalised (augmented) left image each detection's 2D box
in green and, where the head regresses 3D, its projected wireframe
(``utils/visualization.py``: ``cv2.rectangle`` and ``cv2.line``'s pixels
without OpenCV). The PNG goes to ``--out``. ``cv2.putText`` has no
counterpart here: each detection's name, score and box (in the drawn
image) are printed, and ``<out>.txt`` beside the PNG holds the frame's
KITTI result rows, written as the eval CLI writes them (those scoring 0.4
or more; without the hill climb of a config that has one).

Usage:
  python -m visualdet3d_tpu_torch.cli.demo --config=configs/stereo3d.py \\
      --checkpoint_path=workdirs/Stereo3D/checkpoint --index 0 --out demo.png [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

BOX_2D_COLOR = (0, 255, 0)
BOX_3D_COLOR = (255, 255, 0)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Draw one frame\'s detections of the '
                                                 'PyTorch port.')
    parser.add_argument('--config', default='configs/stereo3d.py')
    parser.add_argument('--checkpoint_path', required=True)
    parser.add_argument('--index', type=int, default=0)
    parser.add_argument('--split', default='validation',
                        choices=('training', 'validation', 'test'))
    parser.add_argument('--out', default='demo.png')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; cpu runs the plain paths)')
    return parser.parse_args(argv)


def render(image: np.ndarray, P2: np.ndarray, scores, bbox: np.ndarray, rgb_mean,
           rgb_std) -> np.ndarray:
    """The normalised [H, W, 3] ``image`` back to uint8 RGB, with each
    detection's 2D box (thickness 2) and, for [N, 11] boxes, its 3D
    wireframe through ``P2``, as ``tools/demo.py`` draws them (less the
    text)."""
    from visualdet3d_tpu_torch import geometry
    from visualdet3d_tpu_torch.utils.visualization import draw_3d_box, draw_rectangle
    img = np.clip((image * np.asarray(rgb_std) + np.asarray(rgb_mean)) * 255,
                  0, 255).astype(np.uint8).copy()
    for i in range(len(scores)):
        b = bbox[i]
        draw_rectangle(img, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), BOX_2D_COLOR, 2)
        if bbox.shape[1] > 4:
            state = geometry.back_projection(b[None, 4:11], P2)[0]
            box7 = np.asarray(state, np.float32)[None]
            _, homo, _ = geometry.project_bbox3d(box7, P2.astype(np.float32))
            draw_3d_box(img, np.asarray(homo)[0].T, BOX_3D_COLOR)
    return img


def main(argv=None):
    args = parse_args(argv)
    from visualdet3d_tpu_torch.cli.eval import dataset_of, load_system
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.image_io import write_png
    from visualdet3d_tpu_torch.device import resolve_device
    from visualdet3d_tpu_torch.pipelines import evaluators, testers  # noqa: F401  (registers)
    from visualdet3d_tpu_torch.pipelines.inference_prep import prepare_inference_variables
    from visualdet3d_tpu_torch.registry import PIPELINE_DICT

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.config)
    if cfg.trainer.test_func == 'test_mono_depth':
        raise ValueError('the demo draws detections; MonoDepth predicts depth maps '
                         '(evaluate it with cli/eval.py)')
    dataset = dataset_of(cfg, args.split)
    system = load_system(cfg, args.checkpoint_path, device)
    prepare_inference_variables(cfg, system)
    test_fn = PIPELINE_DICT[cfg.trainer.test_func](system)
    seen = {}

    def recording(batch):
        seen['out'] = test_fn(batch)
        return seen['out']

    stem = os.path.splitext(args.out)[0]
    with tempfile.TemporaryDirectory() as tmp:
        evaluators.test_one(cfg, args.index, dataset, recording, tmp)
        shutil.move(os.path.join(tmp, '%06d.txt' % args.index), stem + '.txt')

    scores, bbox, names = seen['out']
    scores, bbox = np.asarray(scores), np.asarray(bbox)
    if bbox.ndim == 1:
        bbox = bbox.reshape(len(scores), 11 if bbox.size == 0 else -1)
    data = dataset[args.index]
    image = data['image'][0] if isinstance(data['image'], list) else data['image']
    P2 = data['calib'][0] if isinstance(data['calib'], list) else data['calib']
    aug = cfg.data.augmentation
    img = render(image, P2, scores, bbox, aug.rgb_mean, aug.rgb_std)
    write_png(args.out, img)
    for name, score, b in zip(names, scores, bbox):
        print(f'{name} {score:.4f} {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f}')
    print(f'wrote {args.out} and {stem}.txt with {len(scores)} detections')


if __name__ == '__main__':
    main()
