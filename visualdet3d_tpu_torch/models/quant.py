"""Inference dtype and weight bridge shared by the detector systems
(counterpart of the non-int8 half of ``Int8InferenceMixin._inference_cast``
in ``visualdet3d_tpu/models/quant.py``). The int8 half comes with the int8
slice of the port."""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
from torch import nn

from visualdet3d_tpu_torch import convert

INFERENCE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class InferenceMixin:
    """For a system with ``cfg`` (``cfg.inference_dtype``) and ``net``.

    ``cfg.inference_dtype = 'bfloat16'`` runs the network in bf16 on a cast
    copy of the weights, made once and kept until :meth:`weights_changed`.
    """

    net: nn.Module
    # flax module paths the weight bridge skips (parameters inference never reads)
    TRAIN_ONLY_PARAMS: Tuple[str, ...] = ()

    def _init_inference_cache(self) -> None:
        self._cast_nets: Dict[torch.dtype, nn.Module] = {}

    def inference_dtype(self) -> torch.dtype:
        name = self.cfg.get('inference_dtype', 'float32')
        if name not in INFERENCE_DTYPES:
            raise ValueError(f'inference_dtype {name!r} is not ported yet; '
                             f'one of {sorted(INFERENCE_DTYPES)}')
        return INFERENCE_DTYPES[name]

    def inference_net(self) -> nn.Module:
        """The network in the inference dtype: ``self.net`` for f32, else a
        cast copy made once and kept until :meth:`weights_changed`."""
        dtype = self.inference_dtype()
        if dtype == torch.float32:
            return self.net
        if dtype not in self._cast_nets:
            self._cast_nets[dtype] = copy.deepcopy(self.net).to(dtype).eval()
        return self._cast_nets[dtype]

    def weights_changed(self) -> None:
        """Drop the cast copies of the network; call after changing weights."""
        self._cast_nets.clear()

    def load_flax_variables(self, variables) -> List[str]:
        """Load the JAX package's ``{params, batch_stats}`` (as numpy
        arrays) through the weight bridge; returns the skipped leaf names
        (the train-only parameters)."""
        skipped = convert.load_flax_variables(self.net, variables, self.TRAIN_ONLY_PARAMS)
        self.weights_changed()
        return skipped
