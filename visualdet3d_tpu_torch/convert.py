"""Weight bridge: a flax ``{params, batch_stats}`` tree -> the port's
``state_dict``.

The port's modules are named like the flax auto-names (``ResNet_0/layer1_0/
Conv_0`` is ``ResNet_0.layer1_0.Conv_0``), so the bridge maps path for path:

* conv ``kernel`` HWIO -> ``weight`` OIHW, DHWIO -> OIDHW; a grouped or
  depthwise kernel ``[kh, kw, in/groups, out]`` takes the same transpose;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var`` (eps 1e-5 on both
  sides; flax momentum 0.9 is torch momentum 0.1, set by the modules);
* a module's own parameter keeps its name (``LookGround_0/alpha``);
* the int8 ``quant`` collection (``quant_from_flax``) -> the port's int8
  artifact, keyed by flax path: ``kernel_q`` int8 HWIO -> int8
  ``[C_out, kh, kw, C_in]`` (the layout the int8 conv kernel reads),
  ``w_scale``, ``act_scale``, ``bias`` and each ``block_fuse`` entry's
  ``bn{1,2}_scale``/``bn{1,2}_shift`` as f32.

Leaves are read with ``numpy.asarray``, so a tree of numpy arrays (or of
anything that converts to them) works; nothing of JAX is imported. The load
is strict: a leaf without a counterpart raises, unless its module path is
listed in ``skip``, and the skipped leaves are returned by name.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_KERNEL_PERM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_LEAF = {('params', 'kernel'): 'weight', ('params', 'bias'): 'bias',
         ('params', 'scale'): 'weight', ('params', 'alpha'): 'alpha',
         ('batch_stats', 'mean'): 'running_mean', ('batch_stats', 'var'): 'running_var'}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(variables: Mapping, skip: Sequence[str] = ()
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Convert a flax variables tree. ``skip``: module paths
    (``'A_0/B_0'``) whose leaves are left out. Returns (state_dict, skipped
    leaf names, '/'-joined)."""
    state: Dict[str, torch.Tensor] = {}
    skipped: List[str] = []
    bn_modules = set()
    for collection in ('params', 'batch_stats'):
        for path, leaf in _flatten(variables.get(collection, {})):
            name = '/'.join(path)
            if any(name == s or name.startswith(s + '/') for s in skip):
                skipped.append(f'{collection}/{name}')
                continue
            key = (collection, path[-1])
            if key not in _LEAF:
                raise KeyError(f'no torch counterpart for flax leaf {collection}/{name}')
            arr = np.asarray(leaf)
            if key == ('params', 'kernel'):
                if arr.ndim not in _KERNEL_PERM:
                    raise ValueError(f'{name}: kernel of rank {arr.ndim}')
                arr = arr.transpose(_KERNEL_PERM[arr.ndim])
            module = '.'.join(path[:-1])
            if collection == 'batch_stats':
                bn_modules.add(module)
            state[f'{module}.{_LEAF[key]}' if module else _LEAF[key]] = torch.tensor(
                np.ascontiguousarray(arr))
    for module in bn_modules:
        key = f'{module}.num_batches_tracked' if module else 'num_batches_tracked'
        state[key] = torch.tensor(0, dtype=torch.long)
    return state, skipped


def load_flax_variables(module: nn.Module, variables: Mapping,
                        skip: Sequence[str] = ()) -> List[str]:
    """Load a flax variables tree into ``module`` strictly, keeping the
    module's devices and memory formats. Returns the skipped leaf names."""
    state, skipped = flax_to_state_dict(variables, skip)
    module.load_state_dict(state, strict=True)
    return skipped


def quant_from_flax(quant: Mapping) -> Dict[Tuple[str, ...], Dict[str, torch.Tensor]]:
    """The JAX package's nested ``quant`` collection -> ``{flax path: entry}``
    (the port's int8 artifact, ``models/quant.py``)."""
    out: Dict[Tuple[str, ...], Dict[str, torch.Tensor]] = {}

    def walk(node: Mapping, path: Tuple[str, ...]) -> None:
        if 'kernel_q' in node or path[-1:] == ('block_fuse',):
            entry = {}
            for key, leaf in node.items():
                arr = np.asarray(leaf)
                if key == 'kernel_q':
                    entry[key] = torch.tensor(np.ascontiguousarray(
                        arr.astype(np.int8).transpose(3, 0, 1, 2)))
                else:
                    entry[key] = torch.tensor(np.asarray(arr, np.float32))
            out[path] = entry
            return
        for key, value in node.items():
            if not isinstance(value, Mapping):
                raise KeyError(f'no int8 counterpart for quant leaf {"/".join(path + (key,))}')
            walk(value, path + (str(key),))

    walk(quant, ())
    return out
