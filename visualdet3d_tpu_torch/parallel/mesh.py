"""Data parallelism over processes (counterpart of
``visualdet3d_tpu/parallel/mesh.py``), on ``torch.distributed``.

The JAX package runs one jitted step over the global batch on a device
mesh: "a batch mean under jit *is* the global mean", so its gradients and
its BatchNorm statistics are those of the whole batch (exact SyncBatchNorm).
The port keeps that meaning with one process per device, each holding its
slice of the global batch:

* every reduction over the batch in a loss, and every BatchNorm's
  statistics in train mode, go through :func:`all_sum`, a sum across the
  processes that is differentiable (its backward sums the gradient across
  them too). Each process then computes the global batch's loss.
* after the backward, :func:`average_gradients` averages the parameter
  gradients over the processes in one all-reduce. When every process
  computes the same global loss from all-reduced sums, each one's gradient
  comes out ``world_size`` times its share of the true gradient, so the
  average is the gradient of the global batch.

Only ``all_reduce`` and ``broadcast`` are used: the two collectives that
gloo carries for CUDA tensors as well as NCCL does. Without an initialised
process group every helper is the identity, so a single process computes
exactly what it computed before.

The JAX mesh's ``model`` axis is not kept: no model of the repo shards its
weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Union

import torch
import torch.distributed as dist

from visualdet3d_tpu_torch.device import resolve_device


def is_distributed() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def check_process_options(coordinator: Optional[str], num_processes: Optional[int],
                          process_id: Optional[int]) -> bool:
    """Whether the three options ask for a process group: all three given
    (True) or none (False); any other mix raises."""
    given = [v is not None for v in (coordinator, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError('multi-process training needs --coordinator host:port, '
                         '--num_processes N and --process_id i together; got '
                         f'coordinator={coordinator!r}, num_processes={num_processes!r}, '
                         f'process_id={process_id!r}')
    if all(given) and not 0 <= process_id < num_processes:
        raise ValueError(f'--process_id {process_id} is not in [0, {num_processes})')
    return all(given)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Join the process group at ``tcp://<coordinator>`` (``host:port``)
    as rank ``process_id`` of ``num_processes``; returns this process's
    device. Without the three options nothing is initialised and the
    device is ``resolve_device(device)``.

    The device: ``device`` when it names one (``'cpu'``, ``'cuda:1'``),
    else ``cuda:(process_id % device_count)``. ``backend=None`` is NCCL for
    a CUDA device and gloo for the CPU; NCCL that fails to start raises (it
    never gives way to gloo or to the CPU)."""
    if not check_process_options(coordinator, num_processes, process_id):
        return resolve_device(device)
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == 'cuda' and dev.index is None):
        resolve_device('cuda')  # raises without CUDA
        dev = torch.device('cuda', process_id % torch.cuda.device_count())
    else:
        dev = resolve_device(dev)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    kwargs = {'device_id': dev} if backend == 'nccl' else {}
    dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id, **kwargs)
    return dev


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """The data axis: this process's place on it and its length."""
    rank: int
    size: int


def make_mesh() -> Mesh:
    """The data axis of the current process group (one process, size 1,
    without one)."""
    return Mesh(rank(), world_size())


def num_local_batch(global_batch: int, mesh: Mesh) -> int:
    return global_batch // mesh.size


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch: every leaf (nested dicts
    too) whose leading dimension the mesh divides is sliced to its
    ``[rank * n, (rank + 1) * n)`` rows; other leaves pass as they are."""
    if mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    shape = getattr(batch, 'shape', ())
    if len(shape) >= 1 and shape[0] % mesh.size == 0:
        n = shape[0] // mesh.size
        return batch[mesh.rank * n:(mesh.rank + 1) * n]
    return batch


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place
    (the start of training: every process then holds rank 0's weights)."""
    if is_distributed():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _AllSum(torch.autograd.Function):
    """The sum of ``x`` over the processes; the backward sums the gradient
    over them too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, differentiably; ``x`` itself
    without a process group."""
    return _AllSum.apply(x) if is_distributed() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` over the global batch (each
    process holding a slice of the same shape); ``x.mean()`` without a
    process group."""
    if not is_distributed():
        return x.mean()
    return all_sum(x.sum()) / (x.numel() * world_size())


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients of ``params`` over the processes, in one
    all-reduce of their concatenation (parameters without a gradient are
    skipped; the train step gives every parameter one first)."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world_size()
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
