"""Inference-time BatchNorm folding (counterpart of
``visualdet3d_tpu/models/fold_bn.py``).

Pairs are found from the dataflow, not from names: one forward pass with
hooks, and a BatchNorm is folded into a convolution exactly when the
BatchNorm's input *is* that convolution's output tensor. The fold is in
place and in f32, with the JAX package's arithmetic:

  weight' = weight * s          with s = scale / sqrt(var + 1e-5)
  conv with bias:    bias' = s * (bias - mean) + bn_bias, BN -> exact identity
  conv without bias: the BN keeps a pure shift (scale' = 1, mean' = s * mean,
                     var' = 1 - eps)

The ``var' = 1 - eps`` signature is what the int8 quantization reads to find
blocks whose BatchNorms are pure affines (``quant._store_block_fusions``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

_EPS = 1e-5

_CONV = (nn.Conv2d, nn.Conv3d)  # the port has no transposed convs
_BN = (nn.modules.batchnorm._BatchNorm,)


def module_path(name: str) -> Tuple[str, ...]:
    """A ``named_modules`` name -> the flax path tuple."""
    return tuple(name.split('.')) if name else ()


@torch.no_grad()
def detect_conv_bn_pairs(net: nn.Module, *inputs) -> List[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """Run ``net(*inputs)`` once with hooks; return the (conv path, BN path)
    pairs where the BN's input is the conv's output tensor."""
    pairs = []
    conv_out: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = {}
    handles = []

    def on_conv(path):
        def hook(mod, args, out):
            conv_out[id(out)] = (path, out)  # holding the tensor keeps its id unique
        return hook

    def on_bn(path):
        def hook(mod, args):
            hit = conv_out.get(id(args[0])) if args else None
            if hit is not None and hit[1] is args[0]:
                pairs.append((hit[0], path))
        return hook

    for name, mod in net.named_modules():
        if isinstance(mod, _CONV):
            handles.append(mod.register_forward_hook(on_conv(module_path(name))))
        elif isinstance(mod, _BN):
            handles.append(mod.register_forward_pre_hook(on_bn(module_path(name))))
    try:
        net(*inputs)
    finally:
        for h in handles:
            h.remove()
    return pairs


@torch.no_grad()
def fold_batchnorm(net: nn.Module, *inputs) -> List[Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """Fold every conv-BN pair of ``net`` (found by running ``net(*inputs)``
    in eval mode) in place; returns the pairs."""
    was_training = net.training
    net.eval()
    try:
        pairs = detect_conv_bn_pairs(net, *inputs)
    finally:
        net.train(was_training)
    for conv_path, bn_path in pairs:
        conv = net.get_submodule('.'.join(conv_path))
        bn = net.get_submodule('.'.join(bn_path))
        mean, var = bn.running_mean, bn.running_var
        scale = bn.weight if bn.affine else torch.ones_like(mean)
        s = (scale.float() / torch.sqrt(var.float() + _EPS)).float()
        shape = (-1,) + (1,) * (conv.weight.dim() - 1)  # OI[D]HW: scale the outputs
        conv.weight.copy_(conv.weight.float() * s.view(shape))
        if conv.bias is not None:
            bn_bias = bn.bias.float() if bn.affine else 0.0
            conv.bias.copy_(s * (conv.bias.float() - mean.float()) + bn_bias)
            mean.zero_()
            if bn.affine:
                bn.bias.zero_()
        else:
            mean.copy_(s * mean.float())
        var.fill_(1.0 - _EPS)
        if bn.affine:
            bn.weight.fill_(1.0)
    return pairs
