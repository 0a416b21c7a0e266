"""Optimizer and learning-rate schedule builders (counterpart of
``visualdet3d_tpu/solver/optimizers.py``, which chains optax transforms).

Schedules are functions of the count of applied updates, with a
``steps_per_unit`` conversion (1 when the config is iteration based, else
iterations per epoch): StepLR, MultiStepLR, ExponentialLR,
CosineAnnealingLR, PolyLR and GradualWarmupScheduler. The update itself is
``torch.optim`` where it computes the optax update: Adam (eps outside the
square root, bias correction on; torch-style coupled weight decay, the
optax ``add_decayed_weights`` before ``adam``), AdamW (decoupled decay)
and SGD (momentum as an optax trace, coupled decay); global-norm clipping
as ``optax.clip_by_global_norm`` comes first.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch


def make_lr_schedule(scheduler_cfg, base_lr: float, steps_per_unit: int = 1
                     ) -> Callable[[float], float]:
    """fn(update count) -> learning rate."""
    if scheduler_cfg is None:
        return lambda step: base_lr

    name = scheduler_cfg.type_name.lower()
    kw = dict(scheduler_cfg.get('keywords', {}))

    def units(step: int) -> float:
        return float(step // steps_per_unit)

    if name == 'cosineannealinglr':
        t_max = float(kw['T_max'])
        eta_min = float(kw.get('eta_min', 0.0))

        def schedule(step):
            t = min(max(units(step), 0.0), t_max)
            return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max))
        return schedule

    if name == 'steplr':
        step_size = float(kw['step_size'])
        gamma = float(kw.get('gamma', 0.1))
        return lambda step: base_lr * gamma ** math.floor(units(step) / step_size)

    if name == 'multisteplr':
        milestones = sorted(float(m) for m in kw['milestones'])
        gamma = float(kw.get('gamma', 0.1))
        return lambda step: base_lr * gamma ** sum(units(step) >= m for m in milestones)

    if name == 'exponentiallr':
        gamma = float(kw.get('gamma', 1.0))
        return lambda step: base_lr * gamma ** units(step)

    if name == 'polylr':
        gamma = float(kw.get('gamma', 0.9))
        n_iteration = float(kw.get('n_iteration', -1))
        return lambda step: base_lr * max(1.0 - units(step) / n_iteration, 0.0) ** gamma

    if name == 'gradualwarmupscheduler':
        multiplier = float(kw.get('multiplier', 1.0))
        total_epoch = float(kw['total_epoch'])
        after = make_lr_schedule(kw.get('after_scheduler_cfg'), base_lr * multiplier,
                                 steps_per_unit)

        def schedule(step):
            t = units(step)
            if t > total_epoch:
                return after(step - total_epoch * steps_per_unit)
            frac = min(max(t / total_epoch, 0.0), 1.0)
            if multiplier == 1.0:
                return base_lr * frac
            return base_lr * ((multiplier - 1.0) * frac + 1.0)
        return schedule

    raise NotImplementedError(f'unknown scheduler {scheduler_cfg.type_name}')


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: scale every gradient by
    max_norm / norm when the global norm reaches max_norm. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """clip -> optimizer(schedule). ``count`` is the number of applied
    updates: the schedule's step and the count of Adam's bias correction
    (torch.optim advances its own per-parameter step once per ``step()``,
    so a skipped update advances neither, as the optax state kept by the
    JAX step's skip rule does not)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], optim_cfg, scheduler_cfg=None,
                 steps_per_unit: int = 1):
        kw = dict(optim_cfg.get('keywords', {}))
        base_lr = float(kw.pop('lr', 1e-4))
        self.schedule = make_lr_schedule(scheduler_cfg, base_lr, steps_per_unit)
        self.params = [p for p in params if p.requires_grad]
        weight_decay = float(kw.pop('weight_decay', 0.0))
        name = optim_cfg.type_name.lower()
        lr = self.schedule(0)
        if name == 'sgd':
            self.torch_optimizer = torch.optim.SGD(
                self.params, lr=lr, momentum=kw.get('momentum', 0.0),
                nesterov=kw.get('nesterov', False), weight_decay=weight_decay)
        elif name == 'adam':
            betas = tuple(kw.get('betas', (0.9, 0.999)))
            self.torch_optimizer = torch.optim.Adam(self.params, lr=lr, betas=betas,
                                                    eps=kw.get('eps', 1e-8),
                                                    weight_decay=weight_decay)
        elif name == 'adamw':
            self.torch_optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                                     eps=1e-8, weight_decay=weight_decay)
        else:
            raise NotImplementedError(f'unknown optimizer {optim_cfg.type_name}')
        clip = optim_cfg.get('clipped_gradient_norm', None)
        self.clip_norm: Optional[float] = float(clip) if clip else None
        self.count = 0

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params if p.grad is not None],
                                 self.clip_norm)
        lr = self.schedule(self.count)
        for group in self.torch_optimizer.param_groups:
            group['lr'] = lr
        self.torch_optimizer.step()
        self.count += 1


def build_optimizer(params: Iterable[torch.nn.Parameter], optim_cfg, scheduler_cfg=None,
                    steps_per_unit: int = 1) -> Optimizer:
    """The full update: clip -> optimizer(schedule)."""
    return Optimizer(params, optim_cfg, scheduler_cfg, steps_per_unit)
