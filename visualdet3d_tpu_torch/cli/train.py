"""Train a detector from a config file (counterpart of
``visualdet3d_tpu/cli/train.py``), on the card unless ``--device`` names
another.

The epoch loop runs in the JAX CLI's order: an epoch is
``len(dataset) // batch_size`` steps of a loader built anew (so the
sampler replays the same permutation each epoch and only the augmentation
draws differ); the scheduler's units are converted to steps unless
``is_iter_based``; ``train_rtm3d`` gets the epoch in its batch; the loss
terms are buffered on the device and read every ``disp_iter`` steps; a
checkpoint (``checkpoint.py``) is saved every epoch and ``--resume``
continues from the latest. Every ``test_iter`` epochs the config's
``evaluate_func`` (``pipelines/evaluators.py``) runs on the validation
split after the checkpoint, as the JAX loop does: the training weights in
f32 (``inference_dtype`` is set aside for it), the network in eval mode,
then back; its timings go to ``<log_path>/eval_stats.jsonl``. Two raises
at start where the JAX CLI would go on: a config whose ``evaluate_func``
is not registered while an evaluation would fall within ``max_epochs``
(the JAX CLI would fail at that epoch, after training), and the
multi-process options (one process on one device).

Each epoch also appends one JSON line to ``<log_path>/train_stats.jsonl``:
its steps and wall seconds, the seconds the loop waited on the loader
and the ms of each wait, each step's ms (the step ends in a host sync, its
skip rule), torch's CPU threads, the
host-to-device copies' time (CUDA events on the card), the checkpoint's
seconds, the last loss and the kernel launches of the epoch; the first
epoch also the seconds from the start of ``main`` to the first step.

Usage:
  python -m visualdet3d_tpu_torch.cli.train --config=configs/km3d.py [--resume]
  python -m visualdet3d_tpu_torch.cli.train --config=configs/monodepth.py
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import itertools
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from visualdet3d_tpu_torch.ops import launch_counts


def host_batch(batch: dict, pin: bool) -> dict:
    """The array leaves of a collated batch (nested target dicts of arrays
    too) as CPU tensors, in pinned memory when ``pin``; the lists of labels
    and boxes beside them are dropped."""
    def tensor(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.pin_memory() if pin else t

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = tensor(v)
        elif isinstance(v, dict) and all(isinstance(x, np.ndarray) for x in v.values()):
            out[k] = {kk: tensor(x) for kk, x in v.items()}
    return out


def device_batch(batch: dict, device: torch.device) -> dict:
    """``host_batch``'s tensors on ``device`` (asynchronous copies from
    pinned memory)."""
    return {k: ({kk: x.to(device, non_blocking=True) for kk, x in v.items()}
                if isinstance(v, dict) else v.to(device, non_blocking=True))
            for k, v in batch.items()}


def evaluation_epochs(trainer_cfg, start_epoch: int):
    """The epochs after which the loop would evaluate."""
    test_iter = trainer_cfg.get('test_iter', 0)
    if test_iter <= 0:
        return []
    return [e for e in range(start_epoch, trainer_cfg.max_epochs) if (e + 1) % test_iter == 0]


@contextlib.contextmanager
def evaluation_mode(system):
    """The training system as the evaluation reads it: its weights in f32
    (``cfg.inference_dtype`` set to 'float32') and the network in eval
    mode; both restored after."""
    dtype = system.cfg.get('inference_dtype', 'float32')
    was_training = system.net.training
    system.cfg.inference_dtype = 'float32'
    system.net.eval()
    try:
        yield
    finally:
        system.cfg.inference_dtype = dtype
        system.net.train(was_training)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a detector of the PyTorch port.')
    parser.add_argument('--config', default='configs/stereo3d.py')
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; cpu runs the plain paths)')
    parser.add_argument('--max_objects', type=int, default=32)
    parser.add_argument('--pretrained_backbone', default=None,
                        help='a backbone state_dict file (torch.save)')
    parser.add_argument('--coordinator', default=None,
                        help='multi-process training: not ported (ROADMAP Queue A, A4 item 4)')
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    return parser.parse_args(argv)


def build_system(cfg, device):
    """The config's detector on ``device``, with its training-only parts
    (Stereo3D's disparity head) when it has them."""
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT
    cls = DETECTOR_DICT[cfg.detector.name]
    kwargs = {'training': True} if 'training' in inspect.signature(cls).parameters else {}
    return cls(cfg.detector, device=device, **kwargs)


def main(argv=None) -> None:
    t_main = time.perf_counter()
    args = parse_args(argv)
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        raise NotImplementedError(
            '--coordinator/--num_processes/--process_id: multi-process (DDP/SyncBN) training '
            'is not ported yet; see ROADMAP.md Queue A, A4 item 4')

    from visualdet3d_tpu_torch.checkpoint import (CheckpointManager, load_train_state,
                                                  merge_pretrained_backbone, train_state_dict)
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.loader import build_dataloader
    from visualdet3d_tpu_torch.device import resolve_device
    from visualdet3d_tpu_torch.pipelines.train_state import TrainState
    from visualdet3d_tpu_torch.registry import DATASET_DICT, PIPELINE_DICT
    from visualdet3d_tpu_torch.solver.optimizers import build_optimizer
    from visualdet3d_tpu_torch.utils import LossLogger, MetricWriter, Timer
    import visualdet3d_tpu_torch.data  # noqa: F401  (registers the datasets)
    import visualdet3d_tpu_torch.models  # noqa: F401  (registers the detectors)
    from visualdet3d_tpu_torch.pipelines import evaluators, testers, trainers  # noqa: F401

    device = resolve_device(args.device)
    cfg = cfg_from_file(args.config)

    dataset_train = DATASET_DICT[cfg.data.train_dataset](cfg, 'training')
    steps_per_epoch = max(len(dataset_train) // cfg.data.batch_size, 1)
    ckpt = CheckpointManager(cfg.path.checkpoint_path)
    resume_step = ckpt.latest_step() if args.resume else None
    start_epoch = 0 if resume_step is None else resume_step // steps_per_epoch
    evaluate_func = cfg.trainer.get('evaluate_func')
    eval_epochs = evaluation_epochs(cfg.trainer, start_epoch) if evaluate_func else []
    if eval_epochs and evaluate_func not in PIPELINE_DICT:
        known = sorted(name for name in PIPELINE_DICT if name.startswith('evaluate'))
        raise NotImplementedError(
            f'the config evaluates with {evaluate_func!r} after epochs {eval_epochs[:3]}..., '
            f'which is not a registered evaluation ({known}); set trainer.test_iter to 0 or '
            'past max_epochs to train without it')
    dataset_val = DATASET_DICT[cfg.data.val_dataset](cfg, 'validation') if eval_epochs else None

    writer = MetricWriter(cfg.path.log_path)
    loss_logger = LossLogger(writer, 'train')
    pin = device.type == 'cuda'
    collate = dataset_train.collate_fn

    def collate_fn(items):
        return host_batch(collate(items, obj_types=cfg.obj_types,
                                  max_objects=args.max_objects), pin)

    dataloader_train = build_dataloader(
        dataset_train, num_workers=cfg.data.num_workers, batch_size=cfg.data.batch_size,
        collate_fn=collate_fn, training=True)

    system = build_system(cfg, device)
    scheduler_cfg = cfg.get('scheduler', None)
    is_iter_based = (scheduler_cfg or {}).get('is_iter_based', False)
    state = TrainState(build_optimizer(system.net.parameters(), cfg.optimizer, scheduler_cfg,
                                       steps_per_unit=1 if is_iter_based else steps_per_epoch))
    n_params = sum(p.numel() for p in system.net.parameters() if p.requires_grad)
    print(f'number of trained parameters of the model: {n_params:,}')
    writer.add_text('config', str(cfg))

    if args.pretrained_backbone:
        merge_pretrained_backbone(system.net, args.pretrained_backbone)
        system.weights_changed()
        print(f'warm-started backbone from {args.pretrained_backbone}')

    if resume_step is not None:
        load_train_state(system.net, state, ckpt.restore(resume_step))
        system.weights_changed()
        start_epoch = state.step // steps_per_epoch
        print(f'resumed from step {state.step} (epoch {start_epoch})')

    train_step = PIPELINE_DICT[cfg.trainer.training_func](
        system, compute_dtype=cfg.trainer.get('compute_dtype'))
    stats_path = os.path.join(cfg.path.log_path, 'train_stats.jsonl')
    timer = Timer()
    global_step = start_epoch * steps_per_epoch
    print(f'Num training images: {len(dataset_train)}; {steps_per_epoch} steps/epoch on {device}')

    for epoch_num in range(start_epoch, cfg.trainer.max_epochs):
        loss_logger.reset()
        t_epoch = time.perf_counter()
        wait_s = copy_host_s = 0.0
        step_ms, wait_ms, copies = [], [], []
        setup_s = t_epoch - t_main if epoch_num == start_epoch else None
        launches_before = launch_counts()
        data_iter = itertools.islice(iter(dataloader_train), steps_per_epoch)
        pending_metrics = []
        metrics: Optional[dict] = None
        for iter_num in itertools.count():
            t0 = time.perf_counter()
            batch = next(data_iter, None)
            t1 = time.perf_counter()
            wait_s += t1 - t0
            if batch is None:
                break
            wait_ms.append((t1 - t0) * 1e3)
            if device.type == 'cuda':
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
                batch = device_batch(batch, device)
                events[1].record()
                copies.append(events)
            else:
                batch = device_batch(batch, device)
            t2 = time.perf_counter()
            copy_host_s += t2 - t1
            if cfg.trainer.training_func == 'train_rtm3d':
                batch['epoch'] = float(epoch_num)
            metrics = train_step(state, batch)
            step_ms.append((time.perf_counter() - t2) * 1e3)
            global_step += 1
            timer.tick()
            pending_metrics.append(metrics)
            if global_step % cfg.trainer.disp_iter == 0:
                for m in pending_metrics:
                    loss_logger.update({k: v.item() for k, v in m.items()})
                pending_metrics.clear()
                loss_logger.log(global_step)
                eta = timer.compute_eta(global_step, steps_per_epoch * cfg.trainer.max_epochs)
                print(f'Epoch: {epoch_num} | Iteration: {iter_num} | '
                      f'Running loss: {float(metrics["total"]):1.5f} | eta:{eta}', end='\r')
        del data_iter  # ends the loader's producer thread

        t_save = time.perf_counter()
        ckpt.save(global_step, train_state_dict(system.net, state))
        save_s = time.perf_counter() - t_save
        if copies:
            torch.cuda.synchronize()
        launches_after = launch_counts()
        stats = dict(
            epoch=epoch_num, steps=iter_num, global_step=global_step,
            wall_s=time.perf_counter() - t_epoch, setup_s=setup_s, loader_wait_s=wait_s,
            wait_ms=wait_ms, step_ms=step_ms, torch_threads=torch.get_num_threads(),
            copy_host_s=copy_host_s, checkpoint_save_s=save_s,
            copy_device_ms=(sum(s.elapsed_time(e) for s, e in copies)
                            if copies else None),
            loss=None if metrics is None else float(metrics['total']),
            launches={k: launches_after[k] - launches_before[k] for k in launches_after
                      if launches_after[k] != launches_before[k]})
        with open(stats_path, 'a') as f:
            f.write(json.dumps(stats) + '\n')
        print(f'\nepoch {epoch_num}: {json.dumps(stats)}')

        if epoch_num in eval_epochs:
            print(f'\n/**** start testing after training epoch {epoch_num} ******/')
            eval_stats = {}
            before = launch_counts()
            with evaluation_mode(system):
                PIPELINE_DICT[evaluate_func](cfg, system, dataset_val, writer, epoch_num,
                                             stats=eval_stats)
            after = launch_counts()
            evaluators.write_eval_stats(cfg, dict(
                epoch=epoch_num, split='validation', frames=len(dataset_val), device=str(device),
                inference_dtype='float32', **eval_stats,
                launches={k: after[k] - before[k] for k in after if after[k] != before[k]}))
            print(f'/**** finish testing after training epoch {epoch_num} ******/')
        writer.flush()

    writer.close()


if __name__ == '__main__':
    main()
