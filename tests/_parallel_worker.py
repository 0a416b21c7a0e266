"""One process of ``tests/test_torch_parallel.py``'s process groups.

    python tests/_parallel_worker.py CASE RANK WORLD PORT DIR

joins a gloo group of WORLD processes at ``tcp://127.0.0.1:PORT`` as RANK,
reads ``DIR/CASE.in.pt`` (the global inputs, made by the test from numpy
seeds), runs the case on its rows of the global batch and writes
``DIR/CASE.rank<RANK>.pt``. The case functions are also what the test runs
in its own process, without a group, on the whole batch: the reference.
Torch runs on one thread.
"""
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from visualdet3d_tpu_torch.models import blocks  # noqa: E402
from visualdet3d_tpu_torch.models.heads import (detection_3d_head, km3d_head,  # noqa: E402
                                                losses, monodepth_loss, monoflex_head)
from visualdet3d_tpu_torch.parallel import mesh  # noqa: E402

STEPS_PER_EPOCH = 10


def _leaf(x, grad):
    t = torch.as_tensor(x).clone()
    return t.requires_grad_() if grad else t


def _run_loss(name, batched, consts, grad_keys):
    """The loss ``name`` of this process's rows of ``batched``: (its value,
    the gradients of the ``grad_keys`` leaves)."""
    local = mesh.shard_batch(mesh.make_mesh(), batched)
    local = {k: ({kk: _leaf(vv, f'{k}.{kk}' in grad_keys) for kk, vv in v.items()}
                 if isinstance(v, dict) else _leaf(v, k in grad_keys))
             for k, v in local.items()}
    if name == 'detection_3d':
        cls, reg, _ = detection_3d_head.detection_3d_loss(
            local['cls'], local['reg'], consts['anchors'], consts['mean_std'], local['useful'],
            local['ann'], **consts['kw'])
        value = cls[0] + reg[0]
    elif name == 'km3d':
        value = km3d_head.km3d_loss(local['output'], local['gts'], local['P2'], 10.0,
                                    consts['output_w'])[0]
    elif name == 'monoflex':
        value = monoflex_head.monoflex_loss(local['output'], local['gts'], local['P2'])[0]
    elif name == 'stereo_focal':
        value = losses.stereo_focal_loss(local['cost'], local['disp'], variance=0.5, sparse=True)
    elif name == 'monodepth':
        value = (monodepth_loss.si_log_loss(torch.exp(local['log_depth']), local['gt'])
                 + 0.1 * monodepth_loss.smooth_loss(local['log_depth'][..., None],
                                                    local['image']))
    elif name == 'retinanet':
        from visualdet3d_tpu_torch.registry import DETECTOR_DICT
        import visualdet3d_tpu_torch.models  # noqa: F401
        system = DETECTOR_DICT['RetinaNet'](copy.deepcopy(consts['cfg']), device='cpu')
        cls, reg, _ = system.loss(local['images'], None, local['ann'],
                                  apply_fn=lambda net, x: (local['cls'], local['reg']))
        value = cls[0] + reg[0]
    else:
        raise KeyError(name)
    value.backward()
    grads = {}
    for key in grad_keys:
        k, _, kk = key.partition('.')
        leaf = local[k][kk] if kk else local[k]
        grads[key] = leaf.grad.clone()
    return value.detach(), grads


def losses_case(spec):
    """Every loss of ``spec['losses']`` ({name: (batched, consts,
    grad_keys)}): {name: (value, grads)}."""
    return {name: _run_loss(name, *args) for name, args in spec['losses'].items()}


def units_case(spec):
    """The losses, then BatchNorm2d/3d in train mode (outputs, the input
    gradient of the global loss ``sum(y * g)``, the parameter gradients
    averaged over the processes, the running statistics) and the class
    tower's dropout under the same generator."""
    out = {'losses': losses_case(spec)}
    m = mesh.make_mesh()
    for name, make in (('bn2d', blocks.bn2d), ('bn3d', blocks.bn3d)):
        x, g, weight, bias = (torch.as_tensor(a) for a in spec[name])
        bn = make(x.shape[1])
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        bn.train()
        xl = mesh.shard_batch(m, x).clone().requires_grad_()
        y = bn(xl)
        loss = mesh.all_sum((y * mesh.shard_batch(m, g)).sum())
        loss.backward()
        mesh.average_gradients(bn.parameters())
        out[name] = dict(y=y.detach(), dx=xl.grad, dw=bn.weight.grad, db=bn.bias.grad,
                         mean=bn.running_mean.clone(), var=bn.running_var.clone(),
                         loss=loss.detach())
    drop = blocks.ChannelDropout(0.3).train()
    drop.generator = torch.Generator().manual_seed(4)
    out['dropout'] = drop(mesh.shard_batch(m, torch.as_tensor(spec['dropout'])))
    return out


def stereo_case(spec):
    """One stereo training step (``train_stereo_detection``, dropout off)
    from ``spec['state']`` on this process's rows of each batch of
    ``spec['batches']``: the metrics, the gradients the optimizer received
    (averaged over the processes), the parameters and buffers after."""
    from visualdet3d_tpu_torch.pipelines import trainers  # noqa: F401
    from visualdet3d_tpu_torch.pipelines.train_state import TrainState
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT, PIPELINE_DICT
    from visualdet3d_tpu_torch.solver.optimizers import build_optimizer
    import visualdet3d_tpu_torch.models  # noqa: F401
    out = []
    for batch in spec['batches']:
        tsys = DETECTOR_DICT['Stereo3D'](copy.deepcopy(spec['cfg']), device='cpu',
                                         training=True)
        tsys.net.load_state_dict(spec['state'])
        tsys.dropout = False
        tc = spec['train_cfg']
        state = TrainState(build_optimizer(tsys.net.parameters(), tc.optimizer, tc.scheduler,
                                           STEPS_PER_EPOCH))
        grads, update = {}, state.optimizer.step

        def recording_update():
            grads.update({n: p.grad.clone() for n, p in tsys.net.named_parameters()})
            update()
        state.optimizer.step = recording_update
        step = PIPELINE_DICT['train_stereo_detection'](tsys)
        metrics = step(state, mesh.shard_batch(mesh.make_mesh(), batch))
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                        params={n: p.detach().clone() for n, p in tsys.net.named_parameters()},
                        buffers={n: b.clone() for n, b in tsys.net.named_buffers()},
                        count=state.optimizer.count))
    return out


CASES = {'units': units_case, 'stereo': stereo_case}


def main(case, rank, world, port, directory):
    torch.set_num_threads(1)
    torch.distributed.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                                         world_size=world, rank=rank)
    try:
        spec = torch.load(os.path.join(directory, f'{case}.in.pt'), weights_only=False)
        result = CASES[case](spec)
        torch.save(result, os.path.join(directory, f'{case}.rank{rank}.pt'))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
