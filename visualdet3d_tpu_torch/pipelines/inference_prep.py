"""Config-driven inference preparation: fold, cast or quantize (counterpart
of ``visualdet3d_tpu/pipelines/inference_prep.py``).

``cfg.detector.inference_dtype`` names the path, as in the JAX package:

    detector.inference_dtype = 'int8'          # or 'bfloat16'
    detector.calibration = edict(num_batches=8, batch_size=2)

'float32' leaves the system as it is (the training graph's weights);
'bfloat16' folds every conv+BN pair in f32, then the system's inference
copy runs in bf16; 'int8' folds, calibrates the activation scales on
frames of the training split, quantizes (``models/quant.py``), or loads an
artifact that ``cli/quantize.py`` saved (``--quantized_path``). The system
holds its weights, so each function changes it in place.

Two differences from the JAX package, both deliberate:
- a ``quantized_path`` given while ``inference_dtype`` is not 'int8'
  raises (the JAX package ignores it);
- the eval and quantize CLIs calibrate through one function,
  :func:`quantize_on_training_frames`, on the training split read through the train
  dataset and its augmentation (as the JAX quantize CLI reads it; the JAX
  eval CLI calibrates on the split under test). The augmentation draws
  from numpy's global generator, which is seeded to ``CALIBRATION_SEED``
  for the reads and restored after, and the calibration forward runs in
  full f32 with deterministic cuDNN, so an on-the-fly int8 evaluation and
  one from the quantize CLI's artifact compute the same network.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from visualdet3d_tpu_torch.models.quant import INT8_REFUSAL

CALIBRATION_SEED = 0
QUANT_PATH_SEP = '/'


def calibration_batches(cfg, system, dataset) -> list:
    """Calibration batches from ``dataset``: ``detector.calibration``'s
    num_batches (default 8) of batch_size (default 2) frames, evenly spaced
    over the dataset, as the tuples of ``system.int8_calib_inputs``. numpy's
    global generator is seeded to ``CALIBRATION_SEED`` while the frames are
    read (their augmentation draws from it) and restored after."""
    calib_cfg = cfg.detector.get('calibration', {})
    num_batches = int(calib_cfg.get('num_batches', 8))
    batch_size = int(calib_cfg.get('batch_size', 2))
    n_frames = min(len(dataset), num_batches * batch_size)
    indices = np.linspace(0, len(dataset) - 1, n_frames).astype(int)
    caller_state = np.random.get_state()
    np.random.seed(CALIBRATION_SEED)
    try:
        batches = []
        for b in range(0, n_frames, batch_size):
            items = [dataset[int(i)] for i in indices[b:b + batch_size]]
            batches.append(tuple(system.int8_calib_inputs(dataset.collate_fn(items))))
    finally:
        np.random.set_state(caller_state)
    return batches


@contextlib.contextmanager
def full_f32():
    """Convolutions and matmuls in full f32 (no TF32) with deterministic
    cuDNN algorithms, whatever the caller set; restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _require_int8(system) -> None:
    if not hasattr(system, 'int8_calib_inputs'):
        raise NotImplementedError(
            f'{type(system).__name__}: {INT8_REFUSAL}')


def quantize_on_training_frames(cfg, system) -> Dict[tuple, dict]:
    """Fold ``system``'s network, calibrate it on frames of the training
    split (``cfg.data.train_dataset`` with its augmentation,
    :func:`calibration_batches`) in full f32, quantize; the system keeps the
    int8 artifact, which is returned."""
    from visualdet3d_tpu_torch.registry import DATASET_DICT
    import visualdet3d_tpu_torch.data  # noqa: F401  (registers the datasets)
    _require_int8(system)
    system.fold_inference_variables(tuple(cfg.data.rgb_shape[:2]))
    dataset = DATASET_DICT[cfg.data.train_dataset](cfg, 'training')
    batches = calibration_batches(cfg, system, dataset)
    with torch.no_grad(), full_f32():
        absmax = system.calibrate_int8(batches)
    return system.quantize_int8(absmax)


def int8_artifact(system) -> dict:
    """The system's folded network and int8 entries, as ``cli/quantize.py``
    saves them (``checkpoint.save_params``): {'model': state_dict, 'quant':
    {'/'-joined conv path: entry}}, on the CPU."""
    if system.int8_quant is None:
        raise RuntimeError('the system has no int8 artifact: quantize it first')
    return {'model': {k: v.cpu() for k, v in system.net.state_dict().items()},
            'quant': {QUANT_PATH_SEP.join(p): {k: v.cpu() for k, v in e.items()}
                      for p, e in system.int8_quant.items()}}


def load_int8_artifact(system, artifact: dict) -> None:
    """Put :func:`int8_artifact`'s content into ``system``."""
    if 'quant' not in artifact or 'model' not in artifact:
        raise ValueError('not an int8 artifact of cli/quantize.py (it needs the model and '
                         f'quant entries; got {sorted(artifact)})')
    system.net.load_state_dict(artifact['model'])
    system.set_int8_quant({tuple(p.split(QUANT_PATH_SEP)): e
                           for p, e in artifact['quant'].items()})


def prepare_inference_variables(cfg, system, quantized_path: Optional[str] = None) -> None:
    """Apply ``cfg.detector.inference_dtype`` to a system that holds its
    trained weights (in place): 'float32' leaves it as it is; 'bfloat16'
    folds BN in f32 (the system's inference copy then runs in bf16);
    'int8' loads ``quantized_path`` (an artifact of ``cli/quantize.py``) or
    else quantizes on training frames (:func:`quantize_on_training_frames`).
    A ``quantized_path`` with another dtype raises."""
    from visualdet3d_tpu_torch.checkpoint import load_params
    dtype = cfg.detector.get('inference_dtype', 'float32')
    if quantized_path and dtype != 'int8':
        raise ValueError(f'--quantized_path {quantized_path} is an int8 artifact, but the '
                         f"config's detector.inference_dtype is {dtype!r}")
    if dtype == 'float32':
        return
    if dtype == 'int8':
        _require_int8(system)
        if quantized_path:
            load_int8_artifact(system, load_params(quantized_path))
        else:
            quantize_on_training_frames(cfg, system)
        return
    system.fold_inference_variables(tuple(cfg.data.rgb_shape[:2]))
