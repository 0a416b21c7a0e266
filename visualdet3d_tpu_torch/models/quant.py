"""Inference dtypes, BN folding and post-training int8 quantization shared by
the detector systems (counterpart of ``visualdet3d_tpu/models/quant.py`` and
of ``fold_inference_variables``).

Scheme (the JAX package's): symmetric int8, per-output-channel weight scales,
per-tensor activation scales calibrated offline (absmax over calibration
batches). A quantized conv is: quantize the input (``x * (1/act_scale)``,
round half to even, clip to +-127), s8 x s8 -> s32 conv, then
``acc * (w_scale * act_scale) (+ bias)`` in f32, cast to the compute dtype.

Host API, after ``fold_inference_variables(image_hw)``:

    absmax = system.calibrate_int8(batches)     # f32 forward with pre-hooks
    artifact = system.quantize_int8(absmax)     # {path: entry}, kept on the system
    system.cfg.inference_dtype = 'int8'; system.predict(...)

The artifact maps flax module paths (tuples) to entries: a quantized conv's
``{kernel_q [C_out, kh, kw, C_in] s8, w_scale [C_out] f32, act_scale [] f32,
bias? [C_out] f32}``, and ``<block path> + ('block_fuse',)`` to a fusable
BasicBlock's BatchNorm affines ``{bn1_scale, bn1_shift, bn2_scale,
bn2_shift}``. The JAX package's ``quant`` collection comes over through
``convert.quant_from_flax``.

Where JAX intercepts flax methods, the port makes an int8 copy of the folded
network, once, kept until :meth:`InferenceMixin.weights_changed`: floats cast
to the compute dtype (bf16), each selected ``nn.Conv2d`` replaced by an
:class:`Int8Conv2d`, and, under ``cfg.int8_block``, each fusable BasicBlock
by an :class:`Int8BasicBlock`: ``True``/``'pallas'`` runs the blocks of 64
channels through the fused CUDA kernel (``ops/int8_block.py``, K8; the JAX
package routes blocks of at most 64 channels there, and the kernel is for
64), ``'xla'`` runs the JAX package's flat chain with the float residual,
anything else leaves every conv on its own.

Selection reads the config keys ``int8_min_channels`` (64), ``int8_s2d``
(False) and ``int8_all`` (False), not the JAX package's ``VD3D_INT8_*``
environment knobs. Stride-2 convs selected under ``int8_s2d`` run as direct
stride-2 int8 convs: JAX's space-to-depth form is a TPU emitter workaround
whose s32 result is the same.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from visualdet3d_tpu_torch import convert
from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock
from visualdet3d_tpu_torch.models.blocks import calibrating
from visualdet3d_tpu_torch.models.fold_bn import fold_batchnorm, module_path
from visualdet3d_tpu_torch.ops.int8_block import CHANNELS as BLOCK_CHANNELS
from visualdet3d_tpu_torch.ops.int8_block import block_params, int8_basic_block
from visualdet3d_tpu_torch.ops.int8_conv import int8_conv2d, quantize_act

# inference_dtype -> the dtype of the float computation ('int8': its float remainder)
INFERENCE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
                    'int8': torch.bfloat16}
BLOCK_FUSE_KEY = 'block_fuse'
# why a system without int8 hooks (RetinaNet, MonoDepth) refuses an int8 config
INT8_REFUSAL = ('int8 inference is not part of this system: the JAX package has no '
                'calibrate_int8 or quantize_int8 for it either, where an int8 config fails with '
                'an AttributeError')

PathT = Tuple[str, ...]


def default_select(mod: nn.Module, in_channels: int, path: PathT, deny: frozenset,
                   min_channels: int = 64, s2d: bool = False) -> bool:
    """Quantize 2-D ungrouped stride-1 convs with C_in and C_out of at least
    ``min_channels`` that are not in ``deny``; stride-2 convs without
    dilation too when ``s2d``. ``in_channels`` is the channel count of the
    conv's input (``x.shape[1]``, which a conv that runs always matches)."""
    if not (isinstance(mod, nn.Conv2d) and mod.groups == 1
            and in_channels >= min_channels and mod.out_channels >= min_channels
            and tuple(path) not in deny):
        return False
    if tuple(mod.stride) == (1, 1):
        return True
    return tuple(mod.stride) == (2, 2) and s2d and tuple(mod.dilation) == (1, 1)


@torch.no_grad()
def record_act_absmax(net: nn.Module, run: Callable[[tuple], object], batches: Iterable[tuple],
                      select: Callable) -> Dict[PathT, float]:
    """Calibration: the absmax of every selected conv's input over
    ``batches``, in f32, with ``net`` in eval mode (and
    ``blocks.calibrating``: the convs whose outputs eval mode discards run
    too, as JAX's trace calls them); ``run(batch)`` applies the net to one
    batch. Returns {conv path: absmax}."""
    out: Dict[PathT, float] = {}
    handles = []

    def hook(path):
        def pre(mod, args):
            x = args[0]
            if select(mod, x.shape[1], path):
                out[path] = max(out.get(path, 0.0), float(x.float().abs().max()))
        return pre

    for name, mod in net.named_modules():
        if isinstance(mod, nn.Conv2d):
            handles.append(mod.register_forward_pre_hook(hook(module_path(name))))
    was_training = net.training
    net.eval()
    try:
        with calibrating():
            for batch in batches:
                run(batch)
    finally:
        net.train(was_training)
        for h in handles:
            h.remove()
    return out


@torch.no_grad()
def quantize_weight(weight: torch.Tensor):
    """OIHW f32 kernel -> (kernel_q [C_out, kh, kw, C_in] s8, w_scale [C_out]
    f32), per output channel: ``w_scale = max(absmax, 1e-12) / 127``,
    ``kernel_q = clip(rint(w / w_scale), +-127)``."""
    k = weight.detach().float().permute(0, 2, 3, 1).contiguous()
    w_scale = torch.clamp_min(k.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    k_q = torch.clamp(torch.round(k / w_scale[:, None, None, None]), -127, 127).to(torch.int8)
    return k_q, w_scale


@torch.no_grad()
def quantize_variables(net: nn.Module, act_absmax: Dict[PathT, float],
                       select: Callable) -> Dict[PathT, dict]:
    """The int8 artifact of the FOLDED f32 ``net``: an entry for every conv
    of ``act_absmax`` that ``select`` picks, and the fused affines of the
    fusable blocks (:func:`_store_block_fusions`)."""
    quant: Dict[PathT, dict] = {}
    for path in sorted(act_absmax):
        conv = net.get_submodule('.'.join(path))
        if not select(conv, conv.in_channels, path):
            continue
        k_q, w_scale = quantize_weight(conv.weight)
        entry = {'kernel_q': k_q, 'w_scale': w_scale,
                 'act_scale': torch.tensor(max(act_absmax[path], 1e-12) / 127.0,
                                           dtype=torch.float32, device=k_q.device)}
        if conv.bias is not None:
            entry['bias'] = conv.bias.detach().float().clone()
        quant[path] = entry
    _store_block_fusions(net, quant)
    return quant


def flatten_quant(quant: Dict[PathT, dict]) -> Dict[PathT, dict]:
    """The conv entries of an artifact, {conv path: entry}."""
    return {p: e for p, e in quant.items() if 'kernel_q' in e}


@torch.no_grad()
def _store_block_fusions(net: nn.Module, quant: Dict[PathT, dict]) -> None:
    """Find identity-shortcut blocks whose two 3x3 convs are quantized and
    whose BatchNorms are the pure affines that folding leaves (var' = 1 -
    eps), and store their affines under ``<block path> + ('block_fuse',)``:
    ``bn_scale = scale``, ``bn_shift = bias - mean * scale``. Structural, as
    in the JAX package: any module with ``Conv_0``, ``Conv_1``,
    ``BatchNorm_0``, ``BatchNorm_1`` and no ``Conv_2``. A block whose convs
    have a bias gets no entry (the JAX package stores one and its chain
    drops the bias)."""
    qflat = flatten_quant(quant)
    for path in list(qflat):
        if path[-1] != 'Conv_0':
            continue
        bp = path[:-1]
        e1, e2 = qflat.get(bp + ('Conv_0',)), qflat.get(bp + ('Conv_1',))
        if e1 is None or e2 is None or 'bias' in e1 or 'bias' in e2:
            continue  # the fused chain has no place for a conv bias
        k1, k2 = e1['kernel_q'], e2['kernel_q']
        if not (tuple(k1.shape[1:3]) == (3, 3) and tuple(k2.shape[1:3]) == (3, 3)
                and k1.shape[3] == k2.shape[0]):  # identity: C_in == C_out
            continue
        block = net.get_submodule('.'.join(bp))
        bns = [getattr(block, 'BatchNorm_0', None), getattr(block, 'BatchNorm_1', None)]
        if any(bn is None for bn in bns) or hasattr(block, 'Conv_2'):
            continue
        entry = {}
        for tag, bn in zip('12', bns):
            var = bn.running_var.float()
            if not torch.allclose(var + 1e-5, torch.ones_like(var), rtol=1e-5, atol=1e-6):
                break  # not a folded pure-affine BN
            scale = bn.weight.float() if bn.affine else torch.ones_like(var)
            bias = bn.bias.float() if bn.affine else torch.zeros_like(var)
            entry[f'bn{tag}_scale'] = scale.clone()
            entry[f'bn{tag}_shift'] = bias - bn.running_mean.float() * scale
        else:
            quant[bp + (BLOCK_FUSE_KEY,)] = entry


def collect_block_entries(quant: Dict[PathT, dict]) -> Dict[PathT, dict]:
    """{block path: {bn affines, e1, e2}} from the stored ``block_fuse``
    entries."""
    blocks = {}
    for path, fuse in quant.items():
        if path[-1] != BLOCK_FUSE_KEY:
            continue
        bp = path[:-1]
        e1, e2 = quant.get(bp + ('Conv_0',)), quant.get(bp + ('Conv_1',))
        if e1 is not None and e2 is not None:
            blocks[bp] = {**fuse, 'e1': e1, 'e2': e2}
    return blocks


class Int8Conv2d(nn.Module):
    """A quantized ``nn.Conv2d``: NCHW channels_last in, the compute dtype
    out. The input's quantize is a torch pass; the conv and its epilogue are
    ``ops.int8_conv.int8_conv2d`` (the CUDA kernel on the card)."""

    def __init__(self, conv: nn.Conv2d, entry: dict, compute_dtype: torch.dtype):
        super().__init__()
        self.stride, self.dilation = tuple(conv.stride), tuple(conv.dilation)
        (ph, pw) = conv.padding
        self.padding = ((ph, ph), (pw, pw))
        self.compute_dtype = compute_dtype
        act = entry['act_scale'].float()
        self.register_buffer('kernel_q', entry['kernel_q'].contiguous())
        self.register_buffer('inv_act', 1.0 / act)
        self.register_buffer('scale', (entry['w_scale'] * act).float())
        self.register_buffer('bias', entry['bias'].float() if 'bias' in entry else None)

    def forward(self, x):
        xq = quantize_act(x.permute(0, 2, 3, 1).contiguous(), self.inv_act)
        y = int8_conv2d(xq, self.kernel_q, self.stride, self.padding, self.dilation,
                        scale=self.scale, bias=self.bias, out_dtype=self.compute_dtype)
        return y.permute(0, 3, 1, 2)


class Int8BasicBlock(nn.Module):
    """A fused identity-shortcut BasicBlock. ``impl='pallas'``: the fused
    CUDA kernel (K8) with the dequantized residual; ``impl='xla'``: the JAX
    package's flat chain (``_int8_basic_block``) with the float residual,
    its two s32 convs on the int8 conv kernel."""

    def __init__(self, be: dict, impl: str, compute_dtype: torch.dtype):
        super().__init__()
        e1, e2 = be['e1'], be['e2']
        self.impl, self.compute_dtype = impl, compute_dtype
        self.register_buffer('k1', e1['kernel_q'].contiguous())
        self.register_buffer('k2', e2['kernel_q'].contiguous())
        self.register_buffer('inv_act1', 1.0 / e1['act_scale'].float())
        self.register_buffer('params', block_params(e1, e2, be['bn1_scale'], be['bn1_shift'],
                                                    be['bn2_scale'], be['bn2_shift']))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1).contiguous()
        xq = quantize_act(x, self.inv_act1)
        if self.impl == 'pallas':
            y = int8_basic_block(xq, self.k1, self.k2, self.params, self.compute_dtype)
        else:
            p, pad = self.params, ((1, 1), (1, 1))
            h = int8_conv2d(xq, self.k1, padding=pad).float() * p[0] + p[1]
            hq = quantize_act(torch.relu(h), p[2])
            y = int8_conv2d(hq, self.k2, padding=pad).float() * p[3] + p[4]
            y = torch.relu(y + x.float()).to(self.compute_dtype)
        return y.permute(0, 3, 1, 2)


def block_impl(raw) -> str:
    """``cfg.int8_block`` -> 'pallas', 'xla' or '' (per conv), as JAX reads it."""
    if raw in (True, '1', 'pallas'):
        return 'pallas'
    return 'xla' if raw == 'xla' else ''


def _is_fusable_basic_block(mod: nn.Module) -> bool:
    return (isinstance(mod, BasicBlock) and tuple(mod.Conv_0.stride) == (1, 1)
            and tuple(mod.Conv_0.dilation) == (1, 1) and not mod.project)


def _replace(net: nn.Module, path: PathT, new: nn.Module) -> None:
    parent = net.get_submodule('.'.join(path[:-1]))
    setattr(parent, path[-1], new)


def int8_copy(net: nn.Module, quant: Dict[PathT, dict], compute_dtype: torch.dtype,
              impl: str = '') -> nn.Module:
    """The int8 copy of the folded ``net``: floats in ``compute_dtype``,
    quantized convs as :class:`Int8Conv2d`, fusable blocks as
    :class:`Int8BasicBlock` under ``impl``."""
    out = copy.deepcopy(net).to(compute_dtype).eval()
    fused: List[PathT] = []
    if impl:
        for bp, be in sorted(collect_block_entries(quant).items()):
            block = out.get_submodule('.'.join(bp))
            if not _is_fusable_basic_block(block):
                continue
            if impl == 'pallas' and block.Conv_0.out_channels != BLOCK_CHANNELS:
                continue
            _replace(out, bp, Int8BasicBlock(be, impl, compute_dtype))
            fused.append(bp)
    for path, entry in flatten_quant(quant).items():
        if path[:-1] in fused:
            continue
        conv = out.get_submodule('.'.join(path))
        _replace(out, path, Int8Conv2d(conv, entry, compute_dtype))
    return out


class InferenceMixin:
    """For a system with ``cfg`` (``cfg.inference_dtype``), ``net`` and
    ``_net_inputs(image_hw, batch_size)`` (example inputs of ``net``).

    ``cfg.inference_dtype = 'bfloat16'`` runs the network in bf16 on a cast
    copy of the weights, ``'int8'`` on the int8 copy (the quantized convs in
    int8, the rest in bf16); each copy is made once and kept until
    :meth:`weights_changed`.
    """

    net: nn.Module
    # flax module paths the weight bridge skips (parameters inference never reads)
    TRAIN_ONLY_PARAMS: Tuple[str, ...] = ()
    # prediction convs kept in floats unless cfg.int8_all
    int8_deny: Tuple[PathT, ...] = ()

    def _init_inference_cache(self) -> None:
        self._cast_nets: Dict[tuple, nn.Module] = {}
        self.int8_quant: Optional[Dict[PathT, dict]] = None

    def inference_dtype(self) -> torch.dtype:
        """The dtype of the float computation of ``cfg.inference_dtype``."""
        name = self.cfg.get('inference_dtype', 'float32')
        if name not in INFERENCE_DTYPES:
            raise ValueError(f'inference_dtype {name!r} is not one of {sorted(INFERENCE_DTYPES)}')
        return INFERENCE_DTYPES[name]

    def inference_net(self) -> nn.Module:
        """The network of ``cfg.inference_dtype``: ``self.net`` for f32, else
        the cast or int8 copy, made once and kept until :meth:`weights_changed`."""
        if self.cfg.get('inference_dtype', 'float32') == 'int8':
            return self.int8_net(torch.bfloat16, block_impl(self.cfg.get('int8_block', False)))
        dtype = self.inference_dtype()
        if dtype == torch.float32:
            return self.net
        if dtype not in self._cast_nets:
            self._cast_nets[dtype] = copy.deepcopy(self.net).to(dtype).eval()
        return self._cast_nets[dtype]

    def int8_net(self, compute_dtype: torch.dtype = torch.bfloat16, impl: str = '') -> nn.Module:
        """The int8 copy of the network for the artifact of
        :meth:`quantize_int8` (or :meth:`set_int8_quant`)."""
        if self.int8_quant is None:
            raise RuntimeError("inference_dtype='int8' needs quantize_int8 (or set_int8_quant) first")
        key = ('int8', compute_dtype, impl)
        if key not in self._cast_nets:
            self._cast_nets[key] = int8_copy(self.net, self.int8_quant, compute_dtype, impl)
        return self._cast_nets[key]

    def weights_changed(self) -> None:
        """Drop the cast and int8 copies of the network; call after changing
        weights (the int8 artifact stays until it is replaced)."""
        self._cast_nets.clear()

    def load_flax_variables(self, variables) -> List[str]:
        """Load the JAX package's ``{params, batch_stats}`` (as numpy
        arrays) through the weight bridge; returns the skipped leaf names
        (:meth:`bridge_skip`'s)."""
        skipped = convert.load_flax_variables(self.net, variables, self.bridge_skip())
        self.weights_changed()
        return skipped

    def bridge_skip(self) -> Tuple[str, ...]:
        """The flax module paths the weight bridge skips: the train-only
        parameters, which the network does not hold."""
        return self.TRAIN_ONLY_PARAMS

    # ------------------------------------------------------------- folding
    def fold_inference_variables(self, image_hw, batch_size: int = 1):
        """Fold conv+BN pairs of ``self.net`` in place, in f32 (found by one
        forward pass at ``image_hw``); returns the pairs."""
        pairs = fold_batchnorm(self.net, *self._net_inputs(image_hw, batch_size))
        self.weights_changed()
        return pairs

    # ---------------------------------------------------------------- int8
    def _int8_deny_set(self) -> frozenset:
        return frozenset() if self.cfg.get('int8_all', False) else frozenset(self.int8_deny)

    def _int8_select(self) -> Callable:
        deny = self._int8_deny_set()
        return lambda mod, in_channels, path: default_select(
            mod, in_channels, path, deny,
            min_channels=int(self.cfg.get('int8_min_channels', 64)),
            s2d=bool(self.cfg.get('int8_s2d', False)))

    def _calib_run(self, batch: tuple):
        """Apply the f32 network to one calibration batch."""
        raise NotImplementedError

    def calibrate_int8(self, batches: Iterable[tuple]) -> Dict[PathT, float]:
        """Per-conv input absmax of the folded f32 network over ``batches``
        (tuples of :meth:`int8_calib_inputs`' form)."""
        return record_act_absmax(self.net, self._calib_run, batches, self._int8_select())

    def quantize_int8(self, act_absmax: Dict[PathT, float]) -> Dict[PathT, dict]:
        """The FOLDED f32 network -> the int8 artifact, kept on the system for
        ``inference_dtype='int8'`` and returned."""
        quant = quantize_variables(self.net, act_absmax, self._int8_select())
        self.set_int8_quant(quant)
        return quant

    def set_int8_quant(self, quant: Dict[PathT, dict]) -> None:
        """Use ``quant`` (for example the JAX package's, through
        ``convert.quant_from_flax``) for int8 inference, on the system's
        device."""
        device = next(self.net.parameters()).device
        self.int8_quant = {p: {k: v.to(device) for k, v in e.items()} for p, e in quant.items()}
        self.weights_changed()

