#!/usr/bin/env python3
"""Whether training KM3D from disk waits on its loader, on one CUDA card.

Run from the repository root:

    python3 loader_study.py [--frames 160] [--repeat 4]

It writes a synthetic full-size KITTI tree (``testing.write_synthetic_kitti``,
375x1242), precomputes KM3D's imdb, and runs the train CLI
(``python -m visualdet3d_tpu_torch.cli.train``) on ``configs/km3d.py`` with
only the paths and the evaluation overridden: one epoch at batch 16,
384x1280, f32, three ways:

* ``threads``: the config's 8 loader threads, torch's default CPU threads;
* ``threads_torch1``: the same with torch on one CPU thread
  (``OMP_NUM_THREADS=1``), so that the loader threads' torch ops do not each
  spread over every core;
* ``sync``: no loader threads (``num_workers`` 0): each step runs with
  nothing else on the host, and the wait before it is the loader's serial
  time for a batch.

The threaded runs' training split lists each frame ``repeat`` times
(``frames * repeat // 16`` steps): the first step takes seconds (the
kernels' build, cuDNN's plans), in which the loader banks its prefetch
queue's 2 batches and the one in hand, so a short epoch hides a loader
slower than the step. Their steady state is the epoch's last half. ``sync``
lists each frame once (``frames // 16`` steps; its steady state leaves out
the first step). Then the loader alone (the config's 8 threads, the CLI's
collate and pinned batches), under torch's default CPU threads and under
one: the ms a batch over 8 batches after the first. One JSON line a run,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DCN_KERNELS = ('modulated_deform_conv', 'modulated_deform_conv_backward_input',
               'modulated_deform_conv_backward_weight')


def emit(run: str, **fields) -> None:
    print(json.dumps({'run': run, **fields}), flush=True)


def variant_config(work, base, name, num_workers):
    """A config over ``base`` (the tree's paths, its imdb) with its own log
    and checkpoint directories and ``num_workers`` loader threads."""
    path = os.path.join(work, f'{name}.py')
    with open(path, 'w') as f:
        f.write(f"""import os
from visualdet3d_tpu_torch.config import cfg_from_file
cfg = cfg_from_file({base!r})
cfg.path.log_path = os.path.join({work!r}, {name!r}, 'log')
cfg.path.checkpoint_path = os.path.join({work!r}, {name!r}, 'checkpoint')
cfg.data.num_workers = {num_workers}
""")
    return path


def run_cli(config, env_extra):
    """One epoch of the train CLI in a subprocess; its stats line."""
    env = dict(os.environ, **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'visualdet3d_tpu_torch.cli.train',
                           '--config', config], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f'loader_study: the train CLI failed (rc {proc.returncode}):\n'
                 f'{proc.stderr[-3000:]}')
    stats = [json.loads(line.split(': ', 1)[1]) for line in proc.stdout.splitlines()
             if line.startswith('epoch ')]
    return stats[-1], wall


def steady(stats, skip):
    """The epoch's numbers over its steps after the first ``skip``."""
    step, wait = stats['step_ms'][skip:], stats['wait_ms'][skip:]
    launches = {k: stats['launches'].get(k, 0) / stats['steps'] for k in DCN_KERNELS}
    if not (np.isfinite(stats['loss']) and all(v == 16 for v in launches.values())):
        sys.exit(f'loader_study: loss {stats["loss"]}, DCN launches a step {launches}')
    return dict(
        steps=stats['steps'], torch_threads=stats['torch_threads'],
        first_step_ms=stats['step_ms'][0], first_wait_ms=stats['wait_ms'][0],
        steady_from_step=skip, steady_step_ms_mean=statistics.mean(step),
        steady_step_ms_median=statistics.median(step),
        steady_step_ms=step, steady_wait_ms=wait,
        steady_wait_ms_mean=statistics.mean(wait),
        steady_period_ms=statistics.mean(s + w for s, w in zip(step, wait)),
        steady_wait_share=sum(wait) / (sum(wait) + sum(step)),
        epoch_wait_share=stats['loader_wait_s'] / stats['wall_s'],
        epoch_wall_s=stats['wall_s'], setup_s=stats['setup_s'],
        copy_device_ms_per_step=stats['copy_device_ms'] / stats['steps'],
        loss=stats['loss'])


def loader_alone(torch, config, batches=8):
    """The CLI's loader (its dataset, collate and pinned batches) alone:
    ms a batch over ``batches`` batches after the first."""
    from visualdet3d_tpu_torch.cli.train import host_batch
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.loader import build_dataloader
    from visualdet3d_tpu_torch.registry import DATASET_DICT
    import visualdet3d_tpu_torch.data  # noqa: F401
    cfg = cfg_from_file(config)
    dataset = DATASET_DICT[cfg.data.train_dataset](cfg, 'training')
    loader = build_dataloader(
        dataset, num_workers=cfg.data.num_workers, batch_size=cfg.data.batch_size,
        training=True, collate_fn=lambda items: host_batch(
            dataset.collate_fn(items, obj_types=cfg.obj_types), True))
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    ms = (time.perf_counter() - t0) * 1e3 / batches
    it.close()
    return ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--frames', type=int, default=160)
    parser.add_argument('--repeat', type=int, default=4)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('loader_study: torch.cuda.is_available() is False: this study needs a CUDA card')
    sys.path.insert(0, ROOT)
    from chip_smoke import smoke_config
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.cli import imdb_precompute_3d
    from visualdet3d_tpu_torch.config import cfg_from_file

    with tempfile.TemporaryDirectory(prefix='vd3d_loader_study_') as work:
        os.environ['VD3D_WORKDIR'] = os.path.join(work, 'workdirs')
        t0 = time.perf_counter()
        root = testing.write_synthetic_kitti(os.path.join(work, 'kitti'), args.frames, seed=7)
        tree_s = time.perf_counter() - t0
        val = range(args.frames - 4, args.frames)
        bases, imdb_s = {}, {}
        for name, ids in (('once', range(args.frames)),
                          ('repeated', list(range(args.frames)) * args.repeat)):
            split = testing.write_split_files(os.path.join(work, f'split_{name}'), ids, val)
            bases[name] = smoke_config(work, 'km3d.py', name, root, split, 1)
            t0 = time.perf_counter()
            imdb_precompute_3d.run(cfg_from_file(bases[name]))
            imdb_s[name] = time.perf_counter() - t0
        emit('setup', frames=args.frames, repeat=args.repeat, write_tree_s=tree_s,
             imdb_s=imdb_s, host_cpus=os.cpu_count(),
             torch_threads_default=torch.get_num_threads())
        for name, base, workers, env in (
                ('threads', 'repeated', 8, {}),
                ('threads_torch1', 'repeated', 8, {'OMP_NUM_THREADS': '1'}),
                ('sync', 'once', 0, {})):
            stats, wall = run_cli(variant_config(work, bases[base], name, workers), env)
            skip = 1 if base == 'once' else stats['steps'] // 2
            emit(name, loader_threads=workers, process_wall_s=wall, **steady(stats, skip))
        default_threads = torch.get_num_threads()
        for n in (default_threads, 1):
            torch.set_num_threads(n)
            config = variant_config(work, bases['repeated'], 'alone', 8)
            emit('loader_alone', torch_threads=n, loader_threads=8,
                 ms_per_batch=loader_alone(torch, config))
        torch.set_num_threads(default_threads)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed')
    return 0


if __name__ == '__main__':
    sys.exit(main())
