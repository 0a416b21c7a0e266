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
arrive in the f32 master parameters; its input is cast to bf16, so every
conv (the trunk's, the DCN offset convs, the head towers) and every DCN
takes bf16 inputs and bf16 weights; the norms (``models/blocks.py``
``BatchNorm2d``) compute f32 statistics, keep f32 running statistics and
return bf16; the loss is f32 (the detector upcasts the head's maps).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from visualdet3d_tpu_torch.solver.optimizers import Optimizer

COMPUTE_DTYPES = {None: torch.float32, 'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass
class TrainState:
    """``step``: every call of the step, as ``TrainState.step`` in JAX;
    ``optimizer.count``: the applied updates (the optax state's count)."""
    optimizer: Optimizer
    step: int = 0


def mixed_precision_apply(compute_dtype: Optional[str]) -> Callable[[nn.Module, torch.Tensor],
                                                                    Dict[str, torch.Tensor]]:
    """``apply(net, images)`` under the policy of ``compute_dtype``: the
    plain call for f32, else the network on a ``compute_dtype`` cast of its
    floating parameters (buffers untouched) with its input cast too."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f'compute_dtype {compute_dtype!r}: one of {sorted(map(str, COMPUTE_DTYPES))}')
    dtype = COMPUTE_DTYPES[compute_dtype]
    if dtype == torch.float32:
        return lambda net, images: net(images)

    def apply(net, images):
        params = {name: p.to(dtype) if p.is_floating_point() else p
                  for name, p in net.named_parameters()}
        return torch.func.functional_call(net, params, (images.to(dtype),))
    return apply


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
        total = loss.mean()
        total.backward()
        # the skip rule reads the loss on the host: one sync per step
        if bool(total > 0):
            state.optimizer.step()
            system.weights_changed()
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics['total'] = total.detach()
        return metrics

    return step
