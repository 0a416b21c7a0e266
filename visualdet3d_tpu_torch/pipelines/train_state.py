"""Training state and step factory (counterpart of
``visualdet3d_tpu/pipelines/train_state.py``).

One call of the step is the whole update: forward in train mode, the loss,
the backward, then the optimizer update with the reference's "skip the
update when the loss is 0" rule. The JAX step is a pure jitted function
of ``(state, batch)``; here the parameters, batch statistics and optimizer
state live in the system's modules and the optimizer and are updated in
place (no second copy of the weights), and ``TrainState`` carries the
counts.

The mixed-precision policy (``compute_dtype='bfloat16'``, the counterpart
of ``_mixed_precision_interceptor`` / ``_mp_scope``): the network runs on
a bf16 copy of every floating parameter made inside the step by a
differentiable cast (``torch.func.functional_call``), so the gradients
arrive in the f32 master parameters; its inputs are cast to bf16, so every
conv (the trunk's, the DCN offset convs, the head towers, the 3-D convs)
and every DCN and correlation volume takes bf16 inputs and bf16 weights;
the norms (``models/blocks.py`` ``_FlaxBatchNorm``) compute f32
statistics, keep f32 running statistics and return bf16, in eval mode too
(the trunk's under ``norm_eval``); the loss is f32 (the detector upcasts
the predictions). Tensors a module makes itself keep the JAX package's
dtypes: GAC's ``LookGround`` samples in f32 (its P2 stays f32) and casts
the result to bf16 at its 1x1 conv, as the JAX interceptor casts every
conv input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from visualdet3d_tpu_torch.models.blocks import conv_inputs_cast_to
from visualdet3d_tpu_torch.parallel import mesh
from visualdet3d_tpu_torch.solver.optimizers import Optimizer

COMPUTE_DTYPES = {None: torch.float32, 'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass
class TrainState:
    """``step``: every call of the step, as ``TrainState.step`` in JAX;
    ``optimizer.count``: the applied updates (the optax state's count)."""
    optimizer: Optimizer
    step: int = 0


def mixed_precision_apply(compute_dtype: Optional[str]) -> Callable[..., object]:
    """``apply(net, *inputs, **kwargs)`` under the policy of
    ``compute_dtype``: the plain call for f32, else the network on a
    ``compute_dtype`` cast of its floating parameters (buffers untouched)
    with its positional inputs cast too (keyword inputs, such as GAC's P2,
    pass as they are) and every ``FlaxConv2d`` casting its input
    (``models/blocks.conv_inputs_cast_to``)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f'compute_dtype {compute_dtype!r}: one of {sorted(map(str, COMPUTE_DTYPES))}')
    dtype = COMPUTE_DTYPES[compute_dtype]
    if dtype == torch.float32:
        return lambda net, *inputs, **kwargs: net(*inputs, **kwargs)

    def apply(net, *inputs, **kwargs):
        params = {name: p.to(dtype) if p.is_floating_point() else p
                  for name, p in net.named_parameters()}
        with conv_inputs_cast_to(dtype):
            return torch.func.functional_call(net, params, tuple(x.to(dtype) for x in inputs),
                                              kwargs)
    return apply


def _update(state: TrainState, system, total: torch.Tensor,
            loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The backward of ``total`` and the skip rule: the optimizer updates
    the parameters (and its state) only when total > 0, read on the host
    (one sync per step); the running statistics the forward updated stay
    either way. A parameter the loss does not reach (a frozen trunk stage)
    gets a zero gradient, so that weight decay and momentum move it as
    optax moves it (``torch.optim`` would skip it). Under a process group
    the gradients are then averaged over the processes
    (``parallel.mesh.average_gradients``), before the optimizer clips them:
    the losses sum over the global batch, so ``total`` and the skip rule
    are the same on every process. Returns the detached loss terms and
    ``total``."""
    total.backward()
    for p in state.optimizer.params:
        if p.grad is None:  # not reached by the loss (a frozen stage): 0, as jax.grad gives
            p.grad = torch.zeros_like(p)
    mesh.average_gradients(state.optimizer.params)
    if bool(total > 0):
        state.optimizer.step()
        system.weights_changed()
    state.step += 1
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics['total'] = total.detach()
    return metrics


def make_simple_train_step(system, batch_keys: Tuple[str, ...],
                           compute_dtype: Optional[str] = None) -> Callable:
    """Step for systems whose ``loss(*batch_values, epoch=..., apply_fn=...)``
    returns ``(loss, loss_dict)`` (the rtm3d trainer). Returns
    ``step(state, batch) -> metrics``; ``batch`` holds ``batch_keys`` and
    optionally ``epoch`` (the rampup weight's input)."""
    apply_fn = mixed_precision_apply(compute_dtype)

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        kwargs = {'epoch': batch['epoch']} if 'epoch' in batch else {}
        loss, loss_dict = system.loss(*[batch[k] for k in batch_keys], apply_fn=apply_fn,
                                      **kwargs)
        return _update(state, system, loss.mean(), loss_dict)

    return step


def make_stereo_train_step(system, compute_dtype: Optional[str] = None) -> Callable:
    """Step for the stereo detector (``Stereo3D.loss``): the detection loss
    plus the stereo focal disparity loss, the backward, then clipping and
    the optimizer under the skip rule. Returns ``step(state, batch) ->
    metrics``; ``batch`` holds left_images, right_images, P2, P3,
    annotations and optionally disparity. The class tower's dropout masks
    come from the step's own ``torch.Generator`` on the system's device
    (seed 0), drawn anew each step."""
    apply_fn = mixed_precision_apply(compute_dtype)
    generator = torch.Generator(device=system.device).manual_seed(0)

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        cls_loss, reg_loss, loss_dict = system.loss(
            batch['left_images'], batch['right_images'], batch['P2'], batch['P3'],
            batch['annotations'], disparity=batch.get('disparity'), apply_fn=apply_fn,
            generator=generator)
        return _update(state, system, cls_loss.mean() + reg_loss.mean(), loss_dict)

    return step


def make_detection_train_step(system, compute_dtype: Optional[str] = None) -> Callable:
    """Step for the monocular anchor detectors (``Yolo3D.loss``,
    ``GroundAwareYolo3D.loss``): the detection loss, the backward, then
    clipping and the optimizer under the skip rule. Returns ``step(state,
    batch) -> metrics``; ``batch`` holds images, P2 and annotations. The
    class tower's dropout masks come from the step's own
    ``torch.Generator`` on the system's device (seed 0), drawn anew each
    step."""
    apply_fn = mixed_precision_apply(compute_dtype)
    generator = torch.Generator(device=system.device).manual_seed(0)

    def step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad()
        cls_loss, reg_loss, loss_dict = system.loss(
            batch['images'], batch['P2'], batch['annotations'], apply_fn=apply_fn,
            generator=generator)
        return _update(state, system, cls_loss.mean() + reg_loss.mean(), loss_dict)

    return step
