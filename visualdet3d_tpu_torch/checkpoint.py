"""Checkpoints in the port's own format (counterpart of
``visualdet3d_tpu/checkpoint.py``, which uses orbax).

A checkpoint is one ``torch.save`` file, ``<dir>/checkpoint_<step>.pt``,
holding the network's, the optimizer's and the scheduler's ``state_dict``
and the step: the whole training state, so that a run resumes where it
stopped. Files are written to a temporary name and renamed into place, so
a reader never sees half a checkpoint; the last ``max_to_keep`` are kept.
Reading a JAX (orbax) checkpoint needs JAX, so it goes through
``convert.py`` in a script or test that imports both packages.

An eval-only artifact (``save_params`` / ``load_params``: the int8 artifact
of ``cli/quantize.py``, the folded network's ``state_dict`` and its
``quant`` entries) is one ``torch.save`` file, written the same way.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

_NAME = re.compile(r'^checkpoint_(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, checkpoint_path: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(checkpoint_path)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f'checkpoint_{int(step)}.pt')

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Write ``state`` (``state_dict``s and plain values) as the
        checkpoint of ``step``, then drop all but the last ``max_to_keep``."""
        path = self.path(step)
        _atomic_save({**state, 'step': int(step)}, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None,
                map_location: Any = 'cpu') -> Optional[Dict[str, Any]]:
        """The checkpoint of ``step`` (the latest by default), or None when
        there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location, weights_only=True)


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f'{path}.tmp.{os.getpid()}'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path: str, params: Dict[str, Any]) -> str:
    """One-shot save of an eval-only artifact (``state_dict``s, tensors and
    plain values) to the file ``path``, atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_save(params, path)
    return path


def load_params(path: str, map_location: Any = 'cpu') -> Dict[str, Any]:
    """The artifact :func:`save_params` wrote to ``path``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_model_weights(net: nn.Module, model_state: Dict[str, Any],
                       train_only: Tuple[str, ...] = ()) -> None:
    """Load a checkpoint's ``model`` into ``net`` for inference: every key
    of ``net`` must be in it, and the only extra keys allowed are those of
    the train-only modules ``train_only`` (flax paths, ``/``-separated:
    Stereo3D's disparity head, which an inference network does not hold)."""
    prefixes = tuple(p.replace('/', '.') + '.' for p in train_only)
    missing, unexpected = net.load_state_dict(model_state, strict=False)
    unexpected = [k for k in unexpected if not k.startswith(prefixes)]
    if missing or unexpected:
        raise KeyError(f'the checkpoint does not fit the network: missing {missing[:5]}, '
                       f'unexpected {unexpected[:5]}')


def train_state_dict(net: nn.Module, state) -> Dict[str, Any]:
    """What a checkpoint holds of a training run: the network, the
    optimizer (``state.optimizer``, the port's ``solver.Optimizer``) and
    the scheduler's position (its count of applied updates)."""
    return {'model': net.state_dict(),
            'optimizer': state.optimizer.torch_optimizer.state_dict(),
            'scheduler': {'count': state.optimizer.count}}


def load_train_state(net: nn.Module, state, checkpoint: Dict[str, Any]) -> None:
    """Load :func:`train_state_dict`'s content and the step into ``net``
    and ``state`` in place."""
    net.load_state_dict(checkpoint['model'])
    state.optimizer.torch_optimizer.load_state_dict(checkpoint['optimizer'])
    state.optimizer.count = int(checkpoint['scheduler']['count'])
    state.step = int(checkpoint['step'])


def merge_pretrained_backbone(net: nn.Module, path: str) -> List[str]:
    """Warm-start the backbone of ``net`` from a backbone ``state_dict``
    file (``torch.save``): the backbone is the first module holding a
    ``conv1`` (ResNet) or ``base_layer`` (DLA); every key of the file that
    names a tensor of it is copied in, with its shape checked. Returns the
    keys copied."""
    pretrained = torch.load(path, map_location='cpu', weights_only=True)
    prefix = None
    for name, module in net.named_modules():
        if hasattr(module, 'conv1') or hasattr(module, 'base_layer'):
            prefix = name
            break
    if prefix is None:
        raise ValueError('no backbone (a module with conv1 or base_layer) in the network')
    own = net.state_dict()
    loaded = []
    with torch.no_grad():
        for key, value in pretrained.items():
            target = f'{prefix}.{key}' if prefix else key
            if target not in own:
                continue
            if own[target].shape != value.shape:
                raise ValueError(f'{target}: shape {tuple(value.shape)} in {path}, '
                                 f'{tuple(own[target].shape)} in the network')
            own[target].copy_(value)
            loaded.append(target)
    if not loaded:
        raise ValueError(f'{path}: no key matches the backbone {prefix!r}')
    return loaded
