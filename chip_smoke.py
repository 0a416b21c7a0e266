#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (written for an H100).

Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, and imports nothing of JAX. Phases,
each printed as one JSON line:

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   every CUDA kernel of the paths from the sources in the checkout
   (``csrc/correlation.cu``, ``csrc/deform_conv.cu``, ``csrc/int8_conv.cu``,
   ``csrc/int8_block.cu``, one ``nvcc`` each, started together);
2. kernel, kernel_per_forward, kernel_edges: both correlation kernels
   against their plain PyTorch version at the stereo path's shapes (batch
   16, 288x1280), f32 and bf16, with their time (CUDA events, median over
   distinct inputs; and device time from CUDA graphs), the plain version's
   time, one ``torch.bmm`` of every (pair, row) as a yardstick (the whole
   L . R^T, not the same function), the least time the card could take
   (``bound_ms``) and the share of it reached; then ragged edge cases in
   both dtypes (ragged and several column tiles, D > W, two disparity
   chunks, channels over several stages, C off the 16-byte pieces, an
   unaligned right eye);
3. slice, profile, parity: ``Stereo3D.predict`` (ResNet-34 at 288x1280) at
   batch 16 in f32 and bf16 over distinct request batches: ms per batch,
   fps, batch-1 p50 latency, valid detections, the correlation launches
   over that run (set to 0 just before it); a ``torch.profiler`` breakdown
   of one batch-16 ``predict`` per dtype; batch-1 f32 (TF32 off) parity of
   the card against the same model on the CPU; then stereo training:
   corr_bwd_kernel, corr_bwd_per_step, corr_bwd_edges (the correlation
   backward kernel against its plain version at both shapes at batch 16,
   f32 and bf16, CUDA events and device time beside the bound, the plain
   version and a dense ``torch.bmm`` yardstick; W < D, a ragged tile,
   batch 1, several tiles and chunks, C off the 16-byte pieces, separate
   eyes (one unaligned), and the gradients autograd hands over when a
   channels_last conv or an NCHW copy reads the volume); stereo_train
   (``entry.build_stereo_trainer``: bf16 mixed precision at batch 16, f32 at
   batch 8, 288x1280: ms per step, img/s, 2 correlation forward and 2
   backward launches a step, peak memory, a profile, the loss and the
   disparity loss falling over 10 steps on one batch); stereo_train_parity
   (one f32 step at batch 2 on the card against the CPU);
4. deform_kernel, deform_edges: the DCNv2 kernel against its plain version
   at the 7 shapes of the KM3D neck (batch 16, 384x1280), f32 and bf16,
   with seeded offsets (std 2 px, 5% of them 20-40 px, outside the map),
   its time, the plain version's, a cuDNN dense 3x3 conv of the same shape
   as a reference point, and the bound; then the edge cases (samples wholly
   outside, exactly on -1 and H, ragged tiles, stride 2, dilation 2) and the
   wrapper's refusals; dcn_alltaps_kernel, dcn_alltaps_edges: the all-taps
   DCN kernel (K4) at the 16 neck shapes against its plain version and
   against the per-tap kernel (bit for bit), with its time, the per-tap
   kernel's and the bound, and edge cases; dcn_premul_kernel,
   dcn_premul_edges: the lerp-accumulate kernel (K6) against its plain
   version on the same pre-multiplied table (bit for bit) and the whole
   premul op (cuBLAS table + K6) against its plain version at the 8 proj
   shapes, with the times of the table, K6 (events and device time), the op
   and the per-tap kernel on the same shapes, K6's share of its bound, and
   edge cases (the generic instance at 4 and 25 taps among them);
5. km3d_slice, km3d_profile, km3d_parity: ``KM3D.predict`` (DLA-34, the DCN
   neck, ``head_features=256``) at batch 16 in f32 and bf16 over distinct
   request batches, with exactly 16 DCN launches per ``predict``; a
   profiler breakdown with the DCN kernel's share; batch-1 f32 parity of
   the card against the CPU; km3d_dcn_variants: the bf16 predict under the
   four settings of ``VD3D_DCN_ALLTAPS`` and ``VD3D_DCN_PREMUL`` (off,
   all-taps, premul, both): fps, bs1 p50, the launches per predict of each
   DCN forward kernel (16/0/0, 0/16/0, 8/0/8, 0/8/8 on per-tap/all-taps/
   premul) and the DCN share of a profile; km3d_dcn_variants_parity: batch-1
   bf16 under both switches against the CPU; then monoflex_slice,
   monoflex_profile, monoflex_parity: the same for ``MonoFlex.predict``
   (``entry.build_monoflex_system``);
6. deform_bwd_kernel, deform_bwd_edges: the DCNv2 backward kernels against
   the plain backward (autograd through the plain forward) at the 7 neck
   shapes, batch 16, f32 and bf16, offsets and mask as channel slices of one
   [B,Ho,Wo,27] tensor, with their time (the whole backward by CUDA events;
   dx and dW apart by device time from a profiler pass, each beside its own
   bound), the plain version's, the bound and the dx adds in device memory
   (``dx_window_spill``); then edge cases (samples wholly outside, a zero
   mask, C_in 512, ragged tiles, stride 2, dilation 2, C_out 320 (the f32
   dx kernel's dy in pieces), a 7x7 kernel in f32 (its 32-pixel tile),
   offsets of exactly +-R, +-(R - 0.5) and +-(R + 1) around the dx window
   on clipped tiles, an unaligned x) and the wrapper's refusals;
   deform_module_grad: the
   gradients of the whole DCN module (offset conv, slices, sigmoid, both
   kernels) on the card against the CPU, f32, with
   offsets kept away from the integer corners;
7. km3d_train (bf16 mixed precision, then f32), km3d_train_parity: the KM3D
   training step of ``entry.build_km3d_trainer`` (Adam, batch 16,
   384x1280) over distinct synthetic batches: ms per step, img/s, exactly 16
   DCN forward, 16 dx, 16 dW and 16 dW-reduce launches per step, peak memory, a
   profiler breakdown of one step, and the loss falling over 10 steps on one
   batch; one f32 step on the card against the same step on the CPU;
   monoflex_train (bf16 mixed precision, then f32): the same for
   ``entry.build_monoflex_trainer`` at batch 8, and in bf16 one step under
   ``VD3D_DCN_ALLTAPS=1`` (all-taps forward, the backward kernels).
8. int8 inference (``entry.build_int8_system``: Stereo3D at 288x1280, BN
   folded, calibrated, ``int8_all``): int8_conv_edges (the int8 conv kernel
   B8 and the activation quantize kernel against their plain versions: on
   the wgmma path split K under each epilogue, M and N off the tile, K
   tails, boxes over the image's edge; on the cp.async path C_in 72 and 16,
   an unaligned base, stride 2; 1x1, dilation 2, asymmetric padding,
   channel tails, +-127; the quantize at a base off 16-byte alignment; and
   the wrappers' refusals); int8_probe (the int8
   probes K9a/b/c of ``tools/probe_pallas_int8.py`` at their shapes and
   seeds, bit-exact, beside ``torch._int_mm``, CUDA events and CUDA-graph
   device times); int8_slice in three modes (every conv on its own,
   layer1's blocks on the fused kernel K8, and the same folded network in
   bf16): ms per batch 16, fps, bs1 p50, peak memory, valid detections, the
   launches of B8 (per path), the quantize, K8 and K1 per predict, a
   profile; int8_conv_kernel (B8 at every conv shape of the batch-16
   predict, collected by hooks: its plan, s32 bit-exact, the f32 and bf16
   epilogues, its time against cuDNN's bf16 conv of the same shape and,
   at 1x1 stride-1 shapes, ``torch._int_mm``, the bound; int8_quantize: the
   quantize kernel at each input, bit-exact, in CUDA events and device time
   (CUDA graphs) beside its bound and ``torch.quantize_per_tensor``);
   int8_plan, int8_plan_predict (B8's plan against
   its variants, split K, no split and the cp.async path, at K9(a) and at
   the batch-1 predict's shapes, bit-exact under each, event and device
   times, and the int8 predict at batch 1 and 16 under each);
   int8_block_kernel and int8_block_edges (K8 on the
   real layer1 entries and input at batch 16, in events and device time, and
   ragged tiles (a pixel past a tile each way, ragged last tiles), bit for
   bit against its plain version in f32 and bf16); int8_parity (the
   artifact quantized on the CPU, batch-1 int8 predict on the card against
   the CPU's, with the JAX package's decode gates).

9. GAC mono (``entry.build_gac_system``, ``build_gac_trainer``; Car and
   Pedestrian, ResNet-101 with the s2d stem, 288x1280, 1024-channel
   features, 32 anchors a location), for both heads: gac_slice and
   yolo3d_slice (``GroundAwareYolo3D.predict`` and the DCN-headed
   ``Yolo3D.predict`` at batch 16 in f32 and bf16 over distinct request
   batches: fps, bs1 p50, peak memory, valid detections; Yolo3D exactly 1
   DCN forward launch per predict, on the per-tap kernel, also under both
   switches; GAC none); gac_profile and yolo3d_profile (a profiler
   breakdown of one predict with ``grid_sample``'s or the DCN kernel's
   device time, and the trunk, the head and ``LookGround`` alone by CUDA
   events: the head's share); gac_parity and yolo3d_parity (batch-1 f32
   on the card against the CPU, at the stereo decode gates);
   gac_head_dcn_kernel (K3/K5 and K7's dx and dW at the head's [16, 18,
   80, 1024] -> 1024 with seeded offsets, against their plain versions at
   batch 16, in CUDA events and device time beside their bounds, with
   ``dx_f32_plan``'s tile, ``dw_plan``'s split and a cuDNN dense 3x3 conv
   of the shape); gac_train and yolo3d_train (batch 8, bf16 mixed
   precision and f32: ms per step, img/s, peak memory, a profile, the
   loss falling over 10 steps on one batch; Yolo3D 1 DCN forward, 1 dx, 1
   dW and 1 dW reduce launch a step); gac_train_parity and
   yolo3d_train_parity (one f32 step at batch 2 on the card and on the
   CPU, both against the same step on the CPU in f64, at the KM3D step
   gates with the CPU's own distance to f64 as the floor, and each DCN or
   LookGround leaf of the card's step within 1e-3 of the f64 step).

10. Training from a KITTI tree on disk: data_io (the port's PNG writer and
   reader, each filter type's round trip bit for bit at 375x1242 RGB and
   16-bit gray; decode ms an image with the C unfilter and the plain numpy
   one, serially and on 8 threads); kitti_precompute
   (``testing.write_synthetic_kitti``: 32 full-size frames, the rows of
   every PNG cycling through the five filters; the imdb precompute of
   ``configs/km3d.py`` and ``configs/stereo3d.py`` with the anchor priors,
   the disparity precompute; record counts, finite priors, the disparity
   maps' shapes, the seconds of each); cli_train_km3d and cli_train_stereo
   (``python -m visualdet3d_tpu_torch.cli.train`` in a subprocess on a
   config that loads ``configs/km3d.py`` / ``configs/stereo3d.py`` and sets
   only the paths, ``max_epochs`` and the evaluation: one epoch of 2 steps
   (KM3D at batch 16, 384x1280; Stereo3D at batch 4, 288x1280), then
   ``--resume`` to a second; finite losses, 16 DCN forward, dx and dW
   launches a KM3D step, 2 K1 and 2 CB a Stereo3D step, 2 checkpoints, the
   checkpoint restored on the card bit for bit; the loader's ms a batch
   and each stage of an item against the step's ms, the host-to-device
   copies' share, the loader wait's share of an epoch);
   km3d_resnet_parity (KM3D on the depth-18 ``resnet`` core, batch 1, f32,
   the card against the CPU at the KM3D gates).

11. Evaluation on the KITTI tree (before km3d_resnet_parity, in the same
   tree): kitti_eval_oracle (160 frames of synthetic labels written back as
   results: Car AP 100 on bbox, BEV, 3D and AOS at every difficulty; every
   box moved 1 m in x and z: 3D AP below bbox AP; the native matcher's
   tables equal to the Python matcher's; the evaluator's seconds);
   cli_eval_km3d and cli_eval_stereo (``cli.eval`` in this process on the
   train CLI phases' checkpoints, their prediction convs calibrated on the
   4 validation frames, f32 then bf16: a result txt a frame, detections,
   the AP table parsed and finite, 16 DCN forwards (K5 / K3) and 2 K1 a
   frame, ms a frame, the evaluator's seconds); cli_eval_gac_postopt
   (``configs/yolo3d_gac.py`` with its hill-climbing post-optimisation, a
   seeded GAC saved by ``checkpoint.py``: at least one detection refined,
   the post-optimisation's ms a frame); cli_quantize_eval_int8
   (``python -m visualdet3d_tpu_torch.cli.quantize`` on
   ``configs/stereo3d_int8.py``, then the eval CLI from the artifact and
   calibrating on the fly: the same result files byte for byte, B8, the
   quantize and 2 K1 a frame); cli_eval_parity (the f32 result files of
   the card against ``--device cpu``: the same lines and labels, numbers
   at the predict parity gates); cli_train_eval (the train CLI with
   ``test_iter=1`` on KM3D: the AP table after its epoch, 16 DCN launches
   a frame).

12. RetinaNet 2D and MonoDepth (``entry.build_retinanet_system``,
   ``build_monodepth_system`` and their trainers), after the GAC phases:
   retinanet_slice, retinanet_profile (``RetinaNet.predict`` at batch 16,
   384x1280, f32 and bf16: ms a batch, fps, bs1 p50, valid detections, a
   profile with the network's share against decode and NMS),
   retinanet_parity (batch-1 f32 against the CPU); monodepth_slice,
   monodepth_profile (``MonoDepth.predict`` at batch 8, 352x1216, f32 and
   bf16: 3 DCN launches a forward on the per-tap kernel, the dtype each DCN
   computes in (f32 in both: the decoder runs f32 after ``LookGround``, so
   K5), positive finite depth, the DCN share of the device time),
   monodepth_parity; monodepth_dcn_kernel (K5 and K3 forward, K7's dx and
   dW at the U-Net's three shapes, batch 8, against their plain versions,
   in events and device time beside the bound and a cuDNN dense 3x3;
   monodepth_dcn_alltaps and monodepth_dcn_premul: K4 at each shape, K6 at
   up0 and up1, bit for bit on the same table); retinanet_train,
   monodepth_train (batch 8, bf16 mixed precision and f32: ms a step, img/s,
   peak memory, a profile, the loss falling over 10 steps; MonoDepth 3 DCN
   forward, dx, dW and dW-reduce launches a step, and one bf16 step under
   ``VD3D_DCN_ALLTAPS=1`` on K4); retinanet_train_parity,
   monodepth_train_parity (one f32 step at batch 2 on the card and on the
   CPU, both against the CPU's step in f64, the leaves of the DCNs and of
   ``LookGround`` each held on its own). After the evaluation phases of 11,
   on disk: depth_data (``testing.write_synthetic_kitti_depth``: 16 frames
   and 4 validation frames at 375x1242, the item's ms by stage, the depth
   prior precompute CLI's seconds); cli_train_monodepth and
   cli_train_retinanet (the train CLI in a subprocess, one epoch of 2 steps
   at batch 8 and the evaluation after it: 16-bit depth PNGs and the nine
   metrics; RetinaNet's 2-D results and AP table); cli_eval_monodepth (the
   eval CLI at batch 1 over 40 frames: the frame's, the item's and the
   PNG's ms; the card's metrics against ``--device cpu``'s within 1e-4).

Then a ``wall`` line (the script's seconds), the ``kernels`` summary line,
the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 16
N_BATCHES = 6     # distinct request batches per timed main-path run
N_KERNEL_RUNS = 10  # distinct inputs per kernel timing
PARITY_TRAIN_BATCH = 2  # the training steps held against the CPU's
N_BS1 = 12
MONOFLEX_BATCH = 8  # configs/monoflex.py's training batch

# (memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 dense FLOP/s),
# NVIDIA data sheets; the SXM part is the default
CARD_PEAKS = {
    'PCIe': (2.0e12, 51e12, 756e12),
    'SXM': (3.35e12, 67e12, 989e12),
}


T_START = time.perf_counter()  # the elapsed seconds each line carries count from here


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields, 'elapsed_s': time.perf_counter() - T_START}),
          flush=True)


def fail(msg: str) -> None:
    sys.exit(f'chip_smoke: FAILED: {msg}')


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return key, peaks
    return 'SXM', CARD_PEAKS['SXM']


def cuda_ms(fn, inputs, warmup: int = 2):
    """Median CUDA-event time of fn(x) over distinct inputs, in ms."""
    import torch
    for x in inputs[:warmup]:
        fn(x)
    times = []
    for x in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def graph_ms(fn, inputs, reps: int = 20):
    """Median device time of fn(x) over distinct inputs, in ms: each call
    captured once in a CUDA graph (after a warm-up call outside it) and
    replayed ``reps`` times between two CUDA events, so that no host time
    is in it."""
    import torch
    times = []
    for x in inputs:
        fn(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(x)
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
        del graph
    return statistics.median(times)


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of each f32 value."""
    import torch
    mag = v.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def device_profile(torch, fn):
    """Run fn() once under torch.profiler, ending in synchronize(). Returns
    (wall ms, kernel events, op events with device time, device ms): device
    events are the kernels (a CPU op's self device time is that of the
    kernels it launched; the ctypes-launched kernels have no op), less
    torch.optim's range annotations ("Optimizer.step#Adam.step"), which show
    up on the device too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith('Optimizer.')]
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(device_ms > 0, 'profile: no device time recorded')
    return wall_ms, kernels, ops, device_ms


def top_events(evs, n):
    evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:n]
    return [dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, calls=e.count) for e in evs]


def kernel_phase(torch, cv, peaks):
    """Both correlation kernels against the plain version at the main
    path's shapes, f32 and bf16, batch 16."""
    bw, f32_peak, bf16_peak = peaks
    shapes = {'stride4': (72, 320, 64, 96 // 4), 'stride8': (36, 160, 128, 192 // 8)}
    gen = torch.Generator(device='cuda').manual_seed(1)
    results = {}
    for dtype_name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        for kernel in ('correlation_volume_interleaved', 'correlation_volume'):
            results[(kernel, dtype_name)] = {
                'ms': 0.0, 'graph_ms': 0.0, 'plain_ms': 0.0, 'bmm_ms': 0.0, 'bound_ms': 0.0,
                'max_abs_err': 0.0,
                'bytes_bound_ms': 0.0, 'ops_bound_ms': 0.0, 'per_shape': {}}
        for shape_name, (h, w, c, d) in shapes.items():
            inputs = [torch.randn((2 * BATCH, h, w, c), generator=gen, device='cuda').to(dtype)
                      for _ in range(N_KERNEL_RUNS)]
            # the plain version in f32 on the same (rounded) inputs
            ref = cv.correlation_volume_plain(inputs[0][0::2].float(), inputs[0][1::2].float(), d)
            isz = inputs[0].element_size()
            n_bytes = 2 * BATCH * h * w * c * isz + BATCH * h * w * d * isz
            n_flops = 2 * BATCH * h * c * sum(max(w - k, 0) for k in range(d))
            bytes_ms = n_bytes / bw * 1e3
            ops_ms = n_flops / (f32_peak if dtype == torch.float32 else bf16_peak) * 1e3
            split = [(x[0::2].contiguous(), x[1::2].contiguous()) for x in inputs]
            runs = {
                'correlation_volume_interleaved': (
                    lambda x: cv.correlation_volume_interleaved(x, d), inputs),
                'correlation_volume': (lambda lr: cv.correlation_volume(lr[0], lr[1], d), split),
            }
            plain_ms = cuda_ms(lambda x: cv.correlation_volume_plain(x[0::2], x[1::2], d),
                               inputs, warmup=1)
            # yardstick, not the same function: the whole L . R^T of every
            # (pair, row), [W, C] x [C, W], of which the kernel keeps the band
            rows = [(x[0::2].reshape(-1, w, c), x[1::2].reshape(-1, w, c).transpose(1, 2))
                    for x in inputs]
            bmm_ms = cuda_ms(lambda lr: torch.bmm(*lr), rows)
            del rows
            for kernel, (fn, args) in runs.items():
                out = fn(args[0])
                torch.cuda.synchronize()
                err = (out.float() - ref).abs()
                if dtype == torch.float32:
                    tol_ok = bool(err.max() <= 1e-5)
                    tol = 'atol 1e-5'
                else:
                    # one bf16 ulp for the output's rounding, plus the f32
                    # tolerance for the order of the C-term sum (bf16 products
                    # are exact in f32, so the sums differ as in f32)
                    tol_ok = bool((err <= bf16_ulp(ref) + 1e-5).all())
                    tol = 'one bf16 ulp of the f32 plain value + 1e-5'
                max_err = float(err.max())
                check(tol_ok, f'{kernel} {dtype_name} {shape_name}: max abs err {max_err} '
                              f'outside {tol}')
                ms = cuda_ms(fn, args)
                dev_ms = graph_ms(fn, args[:4])  # device time: no host time in it
                r = results[(kernel, dtype_name)]
                r['per_shape'][shape_name] = dict(
                    input=[2 * BATCH, h, w, c], num_disp=d, ms=ms, graph_ms=dev_ms,
                    plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms), share_of_bound=max(bytes_ms, ops_ms) / ms,
                    share_of_bound_device=max(bytes_ms, ops_ms) / dev_ms, bmm_ms=bmm_ms,
                    max_abs_err=max_err, achieved_gbps=n_bytes / (ms * 1e-3) / 1e9)
                r['ms'] += ms
                r['graph_ms'] += dev_ms
                r['plain_ms'] += plain_ms
                r['bmm_ms'] += bmm_ms
                r['bytes_bound_ms'] += bytes_ms
                r['ops_bound_ms'] += ops_ms
                r['max_abs_err'] = max(r['max_abs_err'], max_err)
                emit('kernel', kernel=kernel, dtype=dtype_name, shape=shape_name,
                     max_abs_err=max_err, tolerance=tol, ms=ms, graph_ms=dev_ms,
                     plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                     share_of_bound=max(bytes_ms, ops_ms) / ms,
                     share_of_bound_device=max(bytes_ms, ops_ms) / dev_ms, bmm_ms=bmm_ms,
                     bytes=n_bytes, flops=n_flops)
            del inputs, split, ref
    for (kernel, dtype_name), r in results.items():
        r['bound_ms'] = max(r['bytes_bound_ms'], r['ops_bound_ms'])
        r['bound_by'] = 'bytes' if r['bytes_bound_ms'] >= r['ops_bound_ms'] else 'operations'
        r['share_of_bound'] = r['bound_ms'] / r['ms']
        r['share_of_bound_device'] = r['bound_ms'] / r['graph_ms']
        emit('kernel_per_forward', kernel=kernel, dtype=dtype_name, ms=r['ms'],
             graph_ms=r['graph_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
             share_of_bound=r['share_of_bound'],
             share_of_bound_device=r['share_of_bound_device'], bmm_ms=r['bmm_ms'],
             plain_ms=r['plain_ms'])
    return results


EDGE_CASES = (  # (2B, H, W, C, D), what each reaches
    ((4, 3, 45, 16, 8), 'W=45 (one ragged tile, idle warps)'),
    ((2, 2, 5, 8, 12), 'D=12 > W=5'),
    ((2, 2, 150, 64, 24), 'W=150 (three tiles, the halo across them)'),
    ((2, 1, 70, 136, 30), 'D=30 (two chunks of 15), C=136 (three stages)'),
    ((2, 3, 33, 12, 7), 'C=12 (no 16-byte copies in bf16), D=7'),
)


def edge_case_phase(torch, cv):
    """Ragged edges the main path does not reach, f32 and bf16 with the
    main path's gates: W not a multiple of the 64-column tile, D > W,
    several tiles a row, two disparity chunks, channels over several stages,
    C off the 16-byte pieces, an unaligned right eye; separate eyes and
    interleaved."""
    gen = torch.Generator(device='cuda').manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for (b2, h, w, c, d), name in EDGE_CASES:
            both = torch.randn((b2, h, w, c), generator=gen, device='cuda').to(dtype)
            ref = cv.correlation_volume_plain(both[0::2].float(), both[1::2].float(), d)
            for out in (cv.correlation_volume_interleaved(both, d),
                        cv.correlation_volume(both[0::2].contiguous(), both[1::2].contiguous(),
                                              d)):
                err = (out.float() - ref).abs()
                ok = bool(err.max() <= 1e-5) if dtype == torch.float32 else bool(
                    (err <= bf16_ulp(ref) + 1e-5).all())
                check(ok, f'edge case {name} {dtype}: max abs err {float(err.max())}')
        # separate eyes, the right one a tensor one element off 16-byte alignment
        left = torch.randn((1, 2, 40, 64), generator=gen, device='cuda').to(dtype)
        right = torch.empty(left.numel() + 1, dtype=dtype, device='cuda')[1:].view(left.shape)
        right.copy_(torch.randn(left.shape, generator=gen, device='cuda'))
        ref = cv.correlation_volume_plain(left.float(), right.float(), 24)
        err = (cv.correlation_volume(left, right, 24).float() - ref).abs()
        ok = bool(err.max() <= 1e-5) if dtype == torch.float32 else bool(
            (err <= bf16_ulp(ref) + 1e-5).all())
        check(ok, f'edge case unaligned right eye {dtype}: max abs err {float(err.max())}')
    emit('kernel_edges', ok=True, cases=[name for _, name in EDGE_CASES] + [
        'the right eye off 16-byte alignment (separate eyes)'], dtypes=['float32', 'bfloat16'])


def slice_phase(torch, cv, system, dtype_name):
    """The main path: predict at batch 16 over distinct request batches."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2
    system.cfg.inference_dtype = dtype_name
    gen = torch.Generator(device='cuda').manual_seed(3)
    batches = [(torch.randn((BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'),
                torch.randn((BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'))
               for _ in range(N_BATCHES + 1)]
    P2 = torch.as_tensor(np.tile(KITTI_P2, (BATCH, 1, 1)), device='cuda')
    system.predict(*batches[0], P2)  # warm-up: cuDNN algorithm choice, cast copy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cv.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [system.predict(left, right, P2) for left, right in batches[1:]]
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = dict(cv.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(launches['correlation_volume_interleaved'] == 2 * N_BATCHES,
          f'{dtype_name}: {launches} correlation launches for {N_BATCHES} predict calls '
          f'(expected 2 per call)')
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 32, 11) and o['scores'].shape == (BATCH, 32),
              f'{dtype_name}: output shapes {o["bboxes"].shape} {o["scores"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()), f'{dtype_name}: non-finite {key}')
    check(min(n_valid) > 0, f'{dtype_name}: a batch with no valid detection {n_valid}')

    P21 = P2[:1]
    ones = [(left[:1].clone(), right[:1].clone()) for left, right in batches]
    system.predict(*ones[0], P21)
    lats = []
    for i in range(N_BS1):
        left, right = ones[i % len(ones)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        system.predict(left, right, P21)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t) * 1e3)
    result = dict(dtype=dtype_name, batch=BATCH, image_hw=list(IMAGE_HW),
                  ms_per_batch=ms_batch, fps=BATCH / ms_batch * 1e3,
                  bs1_p50_ms=statistics.median(lats), bs1_ms=lats,
                  valid_per_batch=n_valid, launches=launches,
                  peak_memory_gb=peak_gb)
    emit('slice', **result)
    return result, batches[1], P2


def profile_phase(torch, system, batch, P2, dtype_name):
    """Kernel time by name for one batch-16 predict, the correlation
    kernel's (K1's) device time in it, and the device's busy share of the
    wall time."""
    system.cfg.inference_dtype = dtype_name
    system.predict(*batch, P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(*batch, P2))
    k1 = [e for e in kernels if 'correlation_kernel' in e.key]
    check(sum(e.count for e in k1) == 2, f'profile {dtype_name}: {sum(e.count for e in k1)} '
                                         'correlation kernels in one predict, not 2')
    emit('profile', dtype=dtype_name, wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms,
         correlation_ms=sum(e.self_device_time_total for e in k1) / 1e3,
         top_ops=top_events(ops, 12), top_kernels=top_events(kernels, 12))


def parity_phase(torch, system):
    """Batch 1, f32, TF32 off: the card against the same model on the CPU."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, build_system
    system.cfg.inference_dtype = 'float32'
    cpu = build_system(depth=34, device='cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    rng = np.random.default_rng(4)
    left = torch.from_numpy(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    right = torch.from_numpy(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    P2 = torch.from_numpy(KITTI_P2[None])
    out_gpu = {k: v.cpu() for k, v in system.predict(left, right, P2).items()}
    raw_gpu = [t.float().cpu() for t in system.predict_raw(left, right)]
    out_cpu = cpu.predict(left, right, P2)
    raw_cpu = cpu.predict_raw(left, right)
    raw_err = [float((g - c).abs().max() / c.abs().max()) for g, c in zip(raw_gpu, raw_cpu)]
    valid = out_cpu['valid']
    n_valid = int(valid.sum())
    check(n_valid > 0, 'parity: no valid detection at batch 1')
    check(torch.equal(out_gpu['valid'], valid),
          f'parity: valid sets differ: gpu {out_gpu["valid"].nonzero().tolist()} '
          f'cpu {valid.nonzero().tolist()}')
    check(torch.equal(out_gpu['labels'][valid], out_cpu['labels'][valid]), 'parity: labels differ')
    # rtol 1e-3: cuDNN and oneDNN sum the convs in different orders; atol 1e-3
    # for the entries near zero (alpha, clipped corners)
    box_ok = torch.allclose(out_gpu['bboxes'][valid], out_cpu['bboxes'][valid],
                            rtol=1e-3, atol=1e-3)
    box_err = float((out_gpu['bboxes'][valid] - out_cpu['bboxes'][valid]).abs().max())
    check(box_ok, f'parity: boxes differ by up to {box_err}')
    emit('parity', batch=1, dtype='float32', tf32=False, n_valid=n_valid,
         max_box_abs_err=box_err, raw_rel_err_cls_reg=raw_err,
         max_score_abs_err=float((out_gpu['scores'] - out_cpu['scores']).abs().max()))


# ---------------------------------------------------------------------------
# stereo training: the correlation backward and the training step
# ---------------------------------------------------------------------------

CORR_SHAPES = {'stride4': (72, 320, 64, 96 // 4), 'stride8': (36, 160, 128, 192 // 8)}
STEREO_TRAIN_BATCH = {'bfloat16': 16, 'float32': 8}  # bench.py's stereo_train cells


def corr_bwd_check(torch, cv, both, g, what):
    """The backward kernel on (both, g) against the plain backward in f32 on
    the same (rounded) inputs: f32 within 1e-5 of the largest |value|, bf16
    within one bf16 ulp of the f32 value (bf16 products are exact in f32;
    only the order of the sums differs) plus that f32 allowance. Returns
    the max abs error."""
    out = cv.correlation_backward_interleaved(both, g)
    torch.cuda.synchronize()
    check(out.dtype == both.dtype and out.shape == both.shape,
          f'{what}: gradient {out.dtype} {tuple(out.shape)} for {both.dtype} {tuple(both.shape)}')
    ref = cv.correlation_backward_plain(both.float(), g.float())
    err = (out.float() - ref).abs()
    f32_tol = 1e-5 * float(ref.abs().max())
    if both.dtype == torch.float32:
        ok = bool(err.max() <= f32_tol)
    else:
        ok = bool((err <= bf16_ulp(ref) + f32_tol).all())
    check(ok, f'{what}: max abs err {float(err.max())} (largest |value| '
              f'{float(ref.abs().max())})')
    return float(err.max())


def corr_bwd_kernel_phase(torch, cv, peaks):
    """The correlation backward kernel against the plain backward at the
    training path's shapes (batch 16, 288x1280), f32 and bf16: CUDA events
    and device time (CUDA graphs), the plain version's time, a dense
    ``torch.bmm`` yardstick (not the same function), and the bound: the
    bytes of L, R and g read once and of both gradients written once, or
    the band's multiply-adds."""
    bw, f32_peak, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(31)
    results = {}
    for dtype_name, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        r = {'ms': 0.0, 'graph_ms': 0.0, 'plain_ms': 0.0, 'bmm_ms': 0.0, 'bytes_bound_ms': 0.0,
             'ops_bound_ms': 0.0, 'max_abs_err': 0.0, 'per_shape': {}}
        for shape_name, (h, w, c, d) in CORR_SHAPES.items():
            inputs = [(torch.randn((2 * BATCH, h, w, c), generator=gen, device='cuda').to(dtype),
                       torch.randn((BATCH, h, w, d), generator=gen, device='cuda').to(dtype))
                      for _ in range(N_KERNEL_RUNS)]
            err = corr_bwd_check(torch, cv, *inputs[0], f'corr_bwd {dtype_name} {shape_name}')
            isz = inputs[0][0].element_size()
            n_bytes = isz * (2 * 2 * BATCH * h * w * c + BATCH * h * w * d)
            n_flops = 2 * 2 * BATCH * h * c * sum(max(w - k, 0) for k in range(d))
            bytes_ms = n_bytes / bw * 1e3
            ops_ms = n_flops / (f32_peak if dtype == torch.float32 else bf16_peak) * 1e3

            def run(x):
                return cv.correlation_backward_interleaved(*x)
            ms = cuda_ms(run, inputs)
            dev_ms = graph_ms(run, inputs[:4])
            plain_ms = cuda_ms(lambda x: cv.correlation_backward_plain(*x), inputs[:3], warmup=1)
            # yardstick, not the same function: both products dense, a
            # [W, W] matrix (the band's, zeros included) times [W, C] for
            # each eye of every (pair, row)
            dense = torch.randn((BATCH * h, w, w), generator=gen, device='cuda').to(dtype)
            eyes = [x[0].reshape(BATCH, 2, h * w * c)[:, 0].reshape(BATCH * h, w, c)
                    for x in inputs]
            bmm_ms = 2 * cuda_ms(lambda e: torch.bmm(dense, e), eyes)
            del dense, eyes, inputs
            bound = max(bytes_ms, ops_ms)
            r['per_shape'][shape_name] = dict(
                input=[2 * BATCH, h, w, c], num_disp=d, ms=ms, graph_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bound, share_of_bound=bound / ms,
                share_of_bound_device=bound / dev_ms, bmm_ms=bmm_ms, max_abs_err=err,
                achieved_gbps=n_bytes / (dev_ms * 1e-3) / 1e9)
            emit('corr_bwd_kernel', dtype=dtype_name, shape=shape_name,
                 **r['per_shape'][shape_name], bytes=n_bytes, flops=n_flops)
            for key, value in (('ms', ms), ('graph_ms', dev_ms), ('plain_ms', plain_ms),
                               ('bmm_ms', bmm_ms), ('bytes_bound_ms', bytes_ms),
                               ('ops_bound_ms', ops_ms)):
                r[key] += value
            r['max_abs_err'] = max(r['max_abs_err'], err)
        r['bound_ms'], r['bound_by'] = bound_of(r['bytes_bound_ms'], r['ops_bound_ms'])
        r['share_of_bound'] = r['bound_ms'] / r['ms']
        r['share_of_bound_device'] = r['bound_ms'] / r['graph_ms']
        emit('corr_bwd_per_step', dtype=dtype_name, ms=r['ms'], graph_ms=r['graph_ms'],
             bound_ms=r['bound_ms'], bound_by=r['bound_by'], share_of_bound=r['share_of_bound'],
             share_of_bound_device=r['share_of_bound_device'], plain_ms=r['plain_ms'],
             bmm_ms=r['bmm_ms'])
        results[dtype_name] = r
    return results


CORR_BWD_EDGES = (  # (2B, H, W, C, D), what each reaches
    ((2, 2, 5, 8, 12), 'W=5 < D=12'),
    ((4, 3, 45, 16, 8), 'W=45 (one ragged tile)'),
    ((2, 72, 320, 64, 24), 'batch 1 at the stride-4 shape'),
    ((2, 1, 150, 136, 30), 'W=150 (three tiles), C=136 (three chunks), D=30'),
    ((2, 3, 33, 12, 7), 'C=12 (no 16-byte copies in bf16), W D odd'),
)


def corr_bwd_edge_phase(torch, cv):
    """Edges of the backward kernel, f32 and bf16, with its gates: W < D, a
    ragged tile, batch 1, several tiles and chunks, C off the 16-byte
    pieces; the separate-eyes form (an unaligned right eye among them); and
    the gradient autograd really hands over when the volume is read as a
    channels_last NCHW tensor by a conv (a dense [B, H, W, D] gradient) and
    by an NCHW-contiguous copy (a strided one), against the plain backward
    of the same gradient, through the wrapper's autograd Function."""
    gen = torch.Generator(device='cuda').manual_seed(32)
    for dtype in (torch.float32, torch.bfloat16):
        for (b2, h, w, c, d), name in CORR_BWD_EDGES:
            both = torch.randn((b2, h, w, c), generator=gen, device='cuda').to(dtype)
            g = torch.randn((b2 // 2, h, w, d), generator=gen, device='cuda').to(dtype)
            corr_bwd_check(torch, cv, both, g, f'corr_bwd_edges {name} {dtype}')
        # separate eyes; the right eye one element off 16-byte alignment
        left = torch.randn((1, 2, 40, 64), generator=gen, device='cuda').to(dtype)
        right = torch.empty(left.numel() + 1, dtype=dtype, device='cuda')[1:].view(left.shape)
        right.copy_(torch.randn(left.shape, generator=gen, device='cuda'))
        g = torch.randn((1, 2, 40, 24), generator=gen, device='cuda').to(dtype)
        for l_in, r_in, what in ((left, left.clone(), 'aligned'), (left, right, 'unaligned')):
            dl, dr = cv.correlation_backward(l_in, r_in, g)
            rl, rr = cv.correlation_backward_plain_eyes(l_in.float(), r_in.float(), g.float())
            for out, ref in ((dl, rl), (dr, rr)):
                err = (out.float() - ref).abs()
                tol = 1e-5 * float(ref.abs().max())
                ok = bool(err.max() <= tol) if dtype == torch.float32 else bool(
                    (err <= bf16_ulp(ref) + tol).all())
                check(ok, f'corr_bwd_edges separate eyes {what} {dtype}: max abs err '
                          f'{float(err.max())}')
        # autograd's gradient: a 1x1 conv reading the volume as channels_last
        # NCHW, and an NCHW-contiguous copy (the gradient a strided view);
        # a hook on the volume sees the gradient the Function is handed
        both = torch.randn((4, 36, 160, 128), generator=gen, device='cuda').to(dtype)
        conv = torch.nn.Conv2d(24, 8, 1).cuda().to(dtype).to(memory_format=torch.channels_last)
        weight = torch.randn((2, 24, 36, 160), generator=gen, device='cuda').to(dtype)
        strides = {}
        for how in ('channels_last conv', 'NCHW copy'):
            x = both.clone().requires_grad_()
            cv.reset_launch_counts()
            vol = cv.correlation_volume_interleaved(x, 24)
            seen = []
            vol.register_hook(seen.append)
            if how == 'channels_last conv':
                y = conv(vol.permute(0, 3, 1, 2))
                y.backward(torch.randn(y.shape, generator=gen, device='cuda').to(dtype))
            else:
                (vol.permute(0, 3, 1, 2).contiguous() * weight).sum().backward()
                check(not seen[0].is_contiguous(),
                      f'corr_bwd_edges: the NCHW copy handed a dense gradient {seen[0].stride()}')
            g = seen[0]
            strides[how] = list(g.stride())
            launches = dict(cv.LAUNCHES)
            check(launches['correlation_volume_interleaved'] == 1
                  and launches['correlation_backward_interleaved'] == 1,
                  f'corr_bwd_edges autograd ({how}) {dtype}: launches {launches}')
            ref = cv.correlation_backward_plain(both.float(), g.contiguous().float())
            err = (x.grad.float() - ref).abs()
            tol = 1e-5 * float(ref.abs().max())
            ok = bool(err.max() <= tol) if dtype == torch.float32 else bool(
                (err <= bf16_ulp(ref) + tol).all())
            check(ok and x.grad.dtype == dtype,
                  f'corr_bwd_edges autograd ({how}) {dtype}: max abs err {float(err.max())}, '
                  f'gradient strides {tuple(g.stride())}, dtype {x.grad.dtype}')
    emit('corr_bwd_edges', ok=True, cases=[name for _, name in CORR_BWD_EDGES] + [
        'separate eyes, aligned and the right eye off 16-byte alignment',
        'the gradient of a channels_last conv reading the volume',
        'the gradient of an NCHW-contiguous copy of the volume (strided)'],
         dtypes=['float32', 'bfloat16'], autograd_gradient_strides=strides)


def train_batches_of(torch, make, n, batch_size, seed):
    """n distinct synthetic training batches from the batch builder ``make``
    (``testing.stereo_training_batch`` or ``testing.mono_training_batch``)
    at 288x1280, numpy generator ``seed``, moved to the card before any
    timing."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW
    rng = np.random.default_rng(seed)
    return [{k: torch.as_tensor(v, device='cuda')
             for k, v in make(rng, batch_size, IMAGE_HW).items()} for _ in range(n)]


CORR_KERNEL_NAMES = {'forward': 'correlation_kernel', 'backward': 'correlation_bwd_kernel'}


def stereo_train_phase(torch, cv, compute_dtype):
    """The YOLOStereo3D training step (``build_stereo_trainer``) at
    288x1280, bf16 mixed precision at batch 16 or f32 at batch 8: ms per
    step and img/s over N_BATCHES distinct batches after N_TRAIN_WARMUP
    warm-up steps, ending in ``synchronize()``; the correlation launches of
    that run (2 forward, 2 backward a step); peak memory; a profiler
    breakdown of one step with the correlation kernels' device time and the
    device's busy share; then N_FALL_STEPS steps on one repeated batch, in
    which the loss and the disparity loss stay finite and positive and
    fall."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import IMAGE_HW, build_stereo_trainer
    name = compute_dtype or 'float32'
    batch_size = STEREO_TRAIN_BATCH[name]
    system, state, step = build_stereo_trainer(device='cuda', compute_dtype=compute_dtype,
                                               batch_size=batch_size)
    batches = train_batches_of(torch, testing.stereo_training_batch, N_TRAIN_WARMUP + N_BATCHES,
                               batch_size, seed=33)
    for b in batches[:N_TRAIN_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cv.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(b) for b in batches[N_TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = dict(cv.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {'correlation_volume': 0, 'correlation_volume_interleaved': 2 * N_BATCHES,
            'correlation_backward': 0, 'correlation_backward_interleaved': 2 * N_BATCHES}
    check(launches == want, f'stereo_train {name}: {launches} correlation launches for '
                            f'{N_BATCHES} steps (expected 2 forward and 2 backward a step)')
    losses = [float(m['total']) for m in metrics]
    check(all(np.isfinite(losses)) and min(losses) > 0,
          f'stereo_train {name}: losses {losses}')
    check(state.optimizer.count == state.step == N_TRAIN_WARMUP + N_BATCHES,
          f'stereo_train {name}: {state.optimizer.count} updates in {state.step} steps')
    for p in system.net.parameters():
        check(p.dtype == torch.float32 and bool(torch.isfinite(p).all()),
              f'stereo_train {name}: a master parameter is {p.dtype} or non-finite')
    for buf in system.net.buffers():
        check(not buf.is_floating_point() or buf.dtype == torch.float32,
              f'stereo_train {name}: a running statistic is {buf.dtype}')

    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: step(batches[-1]))
    corr = {kind: [e for e in kernels if key in e.key] for kind, key in CORR_KERNEL_NAMES.items()}
    counts = {kind: sum(e.count for e in evs) for kind, evs in corr.items()}
    check(counts == {'forward': 2, 'backward': 2},
          f'stereo_train {name} profile: correlation kernels in one step {counts}')
    corr_ms = {kind: sum(e.self_device_time_total for e in evs) / 1e3 for kind, evs in corr.items()}

    fall = [{k: float(v) for k, v in step(batches[-1]).items()} for _ in range(N_FALL_STEPS)]
    for key in ('total', 'disparity_loss'):
        seq = [m[key] for m in fall]
        check(all(np.isfinite(seq)) and min(seq) > 0 and seq[-1] < seq[0],
              f'stereo_train {name}: {key} did not stay positive and fall over '
              f'{N_FALL_STEPS} steps on one batch: {seq}')
    result = dict(compute_dtype=name, batch=batch_size, image_hw=list(IMAGE_HW),
                  ms_per_step=ms_step, img_per_s=batch_size / ms_step * 1e3, losses=losses,
                  launches=launches,
                  launches_per_step={k: v / N_BATCHES for k, v in launches.items()},
                  peak_memory_gb=peak_gb, profile_wall_ms=wall_ms, device_ms=device_ms,
                  device_busy_share=device_ms / wall_ms,
                  device_busy_share_of_timed_step=device_ms / ms_step,
                  correlation_kernel_ms=corr_ms, correlation_kernels_per_step=counts,
                  loss_on_one_batch=[m['total'] for m in fall],
                  disparity_loss_on_one_batch=[m['disparity_loss'] for m in fall],
                  top_ops=top_events(ops, 14), top_kernels=top_events(kernels, 14))
    emit('stereo_train', **result)
    del system, state, step, batches
    torch.cuda.empty_cache()
    return result


def stereo_train_parity_phase(torch):
    """One f32 training step (TF32 off) on the card against the same step on
    the CPU: ``build_stereo_trainer`` at batch 2, the same random weights
    and batch, dropout off on both (the two devices' generators draw other
    masks).

    Self-calibrated, as ``km3d_train_parity``: the noise floor is the CPU's
    own gradient with the input images moved by up to two f32 ulps. Gates:
    each loss term within max(8x the floor's difference, 2e-4 of its
    value); the gradients as the backward leaves them (before the update
    clips them in place): the largest elementwise difference within 8x the
    floor's (and 5e-2 of the largest gradient), the norm-wise difference
    over all parameters within 3x the floor's; the running statistics after
    the step within 1e-4 of their largest value; the parameters after the
    Adam step within 2.5 * lr."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import build_stereo_trainer
    batch = train_batches_of(torch, testing.stereo_training_batch, 1, PARITY_TRAIN_BATCH,
                             seed=34)[0]
    gpu, gpu_state, gpu_step = build_stereo_trainer(device='cuda', batch_size=PARITY_TRAIN_BATCH)
    cpu, cpu_state, cpu_step = build_stereo_trainer(device='cpu', batch_size=PARITY_TRAIN_BATCH)
    init = {k: v.cpu() for k, v in gpu.net.state_dict().items()}
    cpu.net.load_state_dict(init)
    cpu.weights_changed()
    floor_sys, floor_state, floor_step = build_stereo_trainer(device='cpu',
                                                              batch_size=PARITY_TRAIN_BATCH)
    floor_sys.net.load_state_dict(init)
    grads = {}
    for tag, sys_, state in (('gpu', gpu, gpu_state), ('cpu', cpu, cpu_state),
                             ('moved', floor_sys, floor_state)):
        sys_.dropout = False
        update = state.optimizer.step

        def recording_update(tag=tag, sys_=sys_, update=update):
            grads[tag] = [(torch.zeros_like(p) if p.grad is None else p.grad).detach()
                          .double().cpu() for p in sys_.net.parameters()]
            update()
        state.optimizer.step = recording_update
    lr = cpu_state.optimizer.schedule(0)
    m_gpu = {k: float(v) for k, v in gpu_step(batch).items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    m_cpu = {k: float(v) for k, v in cpu_step(cpu_batch).items()}
    cpu_s = time.perf_counter() - t0
    # the noise floor: the CPU's step, same weights, the images moved by up
    # to two f32 ulps
    gen = torch.Generator().manual_seed(35)
    moved = dict(cpu_batch)
    for key in ('left_images', 'right_images'):
        u = torch.rand(cpu_batch[key].shape, generator=gen)
        moved[key] = cpu_batch[key] * (1 + 2.0 ** -22 * (2 * u - 1))
    m_moved = {k: float(v) for k, v in floor_step(moved).items()}

    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-30) for k, v in m_cpu.items()}
    loss_floor = {k: abs(m_moved[k] - v) / max(abs(v), 1e-30) for k, v in m_cpu.items()}
    bad = {k: (loss_err[k], loss_floor[k]) for k in m_cpu
           if loss_err[k] > max(8 * loss_floor[k], 2e-4)}
    check(not bad, f'stereo_train_parity: loss terms differ beyond the floor {bad}')
    g_gpu, g_cpu, g_moved = grads['gpu'], grads['cpu'], grads['moved']
    worst = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
    floor = max(float((a - b).abs().max()) for a, b in zip(g_moved, g_cpu))
    gmax = max(float(b.abs().max()) for b in g_cpu)
    den = sum(float(b.norm()) ** 2 for b in g_cpu)
    rel = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_gpu, g_cpu)) / den) ** 0.5
    rel_floor = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_moved, g_cpu)) / den) ** 0.5
    check(worst <= max(8 * floor, 1e-5 * gmax) and worst <= 5e-2 * gmax and rel <= 3 * rel_floor,
          f'stereo_train_parity: gradients differ: max abs {worst} (floor {floor}, gmax '
          f'{gmax}), norm-wise {rel} (floor {rel_floor})')
    names = [n for n, _ in cpu.net.named_parameters()]
    per_leaf = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)), n)
                       for a, b, n in zip(g_gpu, g_cpu, names)), reverse=True)
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for pg, pc in zip(gpu.net.parameters(), cpu.net.parameters()))
    check(param_err <= 2.5 * lr, f'stereo_train_parity: parameters after the step differ by '
                                 f'{param_err} (lr {lr})')
    stats_err = max(float((bg.cpu() - bc).abs().max() / bc.abs().max().clamp_min(1e-30))
                    for bg, bc in zip(gpu.net.buffers(), cpu.net.buffers())
                    if bg.is_floating_point())
    check(stats_err <= 1e-4, f'stereo_train_parity: running statistics differ by {stats_err}')
    emit('stereo_train_parity', batch=PARITY_TRAIN_BATCH, dtype='float32', tf32=False,
         loss_rel_err=loss_err, loss_rel_err_floor=loss_floor,
         grad_max_abs_err=worst, grad_max_abs_err_floor=floor, grad_max=gmax,
         grad_rel_err_all=rel, grad_rel_err_all_floor=rel_floor,
         grad_rel_err_worst_leaves=per_leaf[:4],
         grad_rel_err_median_leaf=statistics.median(e for e, _ in per_leaf),
         param_max_abs_err=param_err, lr=lr, running_stats_rel_err=stats_err,
         cpu_step_s=cpu_s, total=m_gpu['total'])
    del gpu, cpu, floor_sys
    torch.cuda.empty_cache()


# (count per forward, H, W, C_in, C_out) of the 16 DCNs of the KM3D neck at 384x1280
DCN_SHAPES = ((1, 12, 40, 512, 256), (1, 24, 80, 256, 256), (2, 24, 80, 256, 128),
              (1, 24, 80, 256, 64), (2, 48, 160, 128, 128), (4, 48, 160, 128, 64),
              (5, 96, 320, 64, 64))
DCN_PER_FORWARD = sum(shape[0] for shape in DCN_SHAPES)


def dcn_inputs(torch, gen, b, h, w, c_in, c_out, dtype, n, ho=None, wo=None,
               off_std=2.0, far=0.05):
    """n distinct (x, offset, mask) inputs and one (weight, bias): offsets of
    std ``off_std`` px, a share ``far`` of them 20-40 px (outside the map).
    As in ``ModulatedDeformConv``, the offsets are the first 18 channels of
    one [B, Ho, Wo, 27] tensor (pixel stride 27) and the mask the sigmoid of
    the last 9."""
    ho, wo = ho or h, wo or w
    runs = []
    for _ in range(n):
        x = torch.randn((b, h, w, c_in), generator=gen, device='cuda').to(dtype)
        om = torch.randn((b, ho, wo, 27), generator=gen, device='cuda')
        off = om[..., :18] * off_std
        big = torch.sign(off) * (20 + 20 * torch.rand(off.shape, generator=gen, device='cuda'))
        om[..., :18] = torch.where(torch.rand(off.shape, generator=gen, device='cuda') < far,
                                   big, off)
        om[..., 18:] *= 2.0
        om = om.to(dtype)
        runs.append((x, om[..., :18], torch.sigmoid(om[..., 18:])))
    weight = (torch.randn((3, 3, c_in, c_out), generator=gen, device='cuda')
              / (9 * c_in) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn((c_out,), generator=gen, device='cuda')).to(dtype)
    return runs, weight, bias


def dcn_check(torch, dc, args, weight, bias, what, **conv):
    """The kernel against the plain version on the card; returns (max abs
    error, tolerance text). f32: 3e-5 of max|out| (the two sum the K*C_in
    tap products in different orders). bf16: per element, one bf16 ulp of
    the plain pre-bias output plus one of the output: the sampled values are
    rounded identically (explicitly rounded products and sums in both), bf16
    products are exact in f32, so only the f32 sum order differs, which can
    flip the rounding of the pre-bias output, and then of the bias add."""
    out = dc.modulated_deform_conv(*args, weight, bias, **conv)
    ref = dc.modulated_deform_conv_plain(*args, weight, bias, **conv)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f'{what}: {tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} {ref.dtype}')
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        tol = 'atol 3e-5 * max|out|'
        ok = bool(err.max() <= 3e-5 * ref.abs().max() + 1e-7)
    else:
        pre = dc.modulated_deform_conv_plain(*args, weight, None, **conv).float()
        tol = 'one bf16 ulp of the plain pre-bias output + one of the output, per element'
        ok = bool((err <= bf16_ulp(pre) + bf16_ulp(ref.float())).all())
    max_err = float(err.max())
    check(ok, f'{what}: max abs err {max_err} outside {tol}')
    return max_err, tol


def deform_kernel_phase(torch, dc, peaks):
    """The DCN kernel against its plain version at the KM3D neck's 7 shapes,
    batch 16, f32 and bf16; times per shape and weighted per forward."""
    import torch.nn.functional as F
    bw, f32_peak, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(11)
    results = {}
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        tot = dict(ms=0.0, plain_ms=0.0, dense_conv_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   max_abs_err=0.0, per_shape={})
        for count, h, w, c_in, c_out in DCN_SHAPES:
            runs, weight, bias = dcn_inputs(torch, gen, BATCH, h, w, c_in, c_out, dtype,
                                            N_KERNEL_RUNS)
            what = f'modulated_deform_conv {dt} {h}x{w} {c_in}->{c_out}'
            max_err, tol = dcn_check(torch, dc, runs[0], weight, bias, what)
            ms = cuda_ms(lambda a: dc.modulated_deform_conv(*a, weight, bias), runs)
            plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_plain(*a, weight, bias),
                               runs, warmup=1)
            w_oihw = weight.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            dense_ms = cuda_ms(lambda a: F.conv2d(a[0].permute(0, 3, 1, 2), w_oihw, bias,
                                                  padding=1), runs)
            isz = runs[0][0].element_size()
            pixels = BATCH * h * w
            n_bytes = isz * (pixels * (c_in + 27 + c_out) + 9 * c_in * c_out + c_out)
            n_flops = 2 * pixels * 9 * c_in * c_out
            bytes_ms = n_bytes / bw * 1e3
            ops_ms = n_flops / (f32_peak if dt == 'f32' else bf16_peak) * 1e3
            shape = dict(count=count, x=[BATCH, h, w, c_in], c_out=c_out, ms=ms,
                         plain_ms=plain_ms, dense_conv_ms=dense_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                         max_abs_err=max_err, tflops=n_flops / (ms * 1e-3) / 1e12)
            tot['per_shape'][f'{h}x{w} {c_in}->{c_out}'] = shape
            for key, v in (('ms', ms), ('plain_ms', plain_ms), ('dense_conv_ms', dense_ms),
                           ('bytes_ms', bytes_ms), ('ops_ms', ops_ms)):
                tot[key] += count * v
            tot['max_abs_err'] = max(tot['max_abs_err'], max_err)
            emit('deform_kernel', kernel='modulated_deform_conv', dtype=dt, tolerance=tol,
                 bytes=n_bytes, flops=n_flops, **shape)
            del runs
        tot['bound_ms'] = max(tot['bytes_ms'], tot['ops_ms'])
        tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
        results[dt] = tot
        emit('deform_kernel_per_forward', dtype=dt, dcn_launches=DCN_PER_FORWARD,
             **{k: v for k, v in tot.items() if k != 'per_shape'})
    return results


def deform_edge_phase(torch, dc):
    """Edge cases the KM3D shapes do not reach, both dtypes, and the
    wrapper's refusals."""
    gen = torch.Generator(device='cuda').manual_seed(12)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, h, w, c_in, c_out), conv, off_std, far in (
                ('offsets of 30 px: wholly outside, output = bias', (2, 10, 14, 6, 5), {},
                 0.0, 1.0),
                ('ragged tiles: 63 px, C_in 33, C_out 70', (2, 7, 9, 33, 70), {}, 2.0, 0.05),
                ('135 px, C_in 40, C_out 5', (1, 9, 15, 40, 5), {}, 3.0, 0.05),
                ('stride 2', (2, 10, 14, 6, 5), dict(stride=2), 2.0, 0.05),
                ('dilation 2', (2, 10, 14, 6, 5), dict(padding=2, dilation=2), 2.0, 0.05)):
            ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                                  conv.get('dilation', 1))
            runs, weight, bias = dcn_inputs(torch, gen, b, h, w, c_in, c_out, dtype, 1,
                                            ho=ho, wo=wo, off_std=off_std, far=far)
            dcn_check(torch, dc, runs[0], weight, bias, f'edge {name} {dtype}', **conv)
            cases.append(name)
        # samples exactly on rows/columns -1, H - 1 and H
        runs, weight, bias = dcn_inputs(torch, gen, 1, 6, 7, 4, 3, dtype, 1, off_std=0.0, far=0.0)
        x, off, mask = runs[0]
        off = off.float()
        off[0, 0, 0, 0::2] = torch.tensor([0, 0, 0, -1, 0, 0, 6, 5, 4.0], device='cuda')
        off[0, 3, 3, 1::2] = torch.tensor([-3, 3.5, 2, -1, 0, 0, 0.5, 0, 0], device='cuda')
        dcn_check(torch, dc, (x, off.to(dtype), mask), weight, bias, f'edge -1/H {dtype}')
        cases.append('samples on -1, H - 1 and H')
        # a contiguous x whose base is off 16-byte alignment: scalar loads
        runs, weight, bias = dcn_inputs(torch, gen, 2, 9, 11, 64, 64, dtype, 1)
        x, off, mask = runs[0]
        shifted = torch.empty(x.numel() + 1, dtype=dtype, device='cuda')[1:].view(x.shape)
        shifted.copy_(x)
        dcn_check(torch, dc, (shifted, off, mask), weight, bias, f'edge unaligned x {dtype}')
        cases.append('x base off 16-byte alignment')
    # what the kernel does not take raises, never falls back
    x, off, mask = runs[0]
    refusals = (
        ('NCHW permuted to NHWC', ValueError,
         lambda: dc.modulated_deform_conv(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                                          off, mask, weight, bias)),
        ('float16', TypeError, lambda: dc.modulated_deform_conv(
            x.half(), off.half(), mask.half(), weight.half(), bias.half())),
        ('a CPU weight', ValueError, lambda: dc.modulated_deform_conv(
            x, off, mask, weight.cpu(), bias)),
        ('a CPU bias', ValueError, lambda: dc.modulated_deform_conv(
            x, off, mask, weight, bias.cpu())),
    )
    for name, exc, fn in refusals:
        try:
            fn()
        except exc:
            continue
        fail(f'modulated_deform_conv took {name} instead of raising {exc.__name__}')
    emit('deform_edges', ok=True, cases=sorted(set(cases)), refused=[r[0] for r in refusals])


# ---------------------------------------------------------------------------
# the DCN forward variants (slice 5): all taps per block (K4) and the
# lerp-accumulate of the pre-multiplied table (K6)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def dcn_switches(alltaps=False, premul=False):
    """The JAX package's switches ``VD3D_DCN_ALLTAPS`` and ``VD3D_DCN_PREMUL``
    set (or cleared) inside a ``with`` block, restored after."""
    values = {'VD3D_DCN_ALLTAPS': alltaps, 'VD3D_DCN_PREMUL': premul}
    saved = {key: os.environ.pop(key, None) for key in values}
    os.environ.update({key: '1' for key, on in values.items() if on})
    try:
        yield
    finally:
        for key, value in saved.items():
            os.environ.pop(key, None)
            if value is not None:
                os.environ[key] = value


def dcn_bf16_check(torch, dc, args, weight, out, ref, pre, what, **conv):
    """The gate of a bf16 DCN kernel against the plain version: per element,
    one bf16 ulp of the plain pre-bias output plus one of the output (the
    sampled values are rounded identically and bf16 products are exact in
    f32, so the two differ by the order of the f32 sum, which can flip the
    rounding of the pre-bias output and then of the bias add), plus the
    f32 summation bound of the two sums, 2 n 2^-23 sum|terms| (n = K C_in
    products; 2^-23 covers the tensor cores' accumulation as well as the
    IEEE one): where the K C_in products cancel to an output far below
    their sizes, the orders alone move the result by bf16 ulps of that
    small output. sum|terms| is bounded by the plain version on |x| and
    |W| (the lerp weights and the mask are not negative)."""
    check(out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16,
          f'{what}: {tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} {ref.dtype}')
    x, offset, mask = args
    n = weight.shape[0] * weight.shape[1] * weight.shape[2]
    mag = dc.modulated_deform_conv_plain(x.abs(), offset, mask, weight.abs(), None,
                                         **conv).float()
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= bf16_ulp(pre.float()) + bf16_ulp(ref.float())
               + 2 * n * 2.0 ** -23 * mag).all())
    check(ok, f'{what}: max abs err {float(err.max())} outside one bf16 ulp of the plain '
              f'pre-bias output + one of the output + the f32 summation bound')
    return float(err.max())


def alltaps_check(torch, dc, args, weight, bias, what, **conv):
    """K4 against the plain version (``dcn_bf16_check``) and against the
    per-tap kernel B4 (bits); returns (max abs err to plain, max abs
    diff to B4, whether K4 and B4 are equal bit for bit)."""
    out = dc.modulated_deform_conv_alltaps(*args, weight, bias, **conv)
    ref = dc.modulated_deform_conv_plain(*args, weight, bias, **conv)
    pre = dc.modulated_deform_conv_plain(*args, weight, None, **conv)
    with dcn_switches():
        b4 = dc.modulated_deform_conv(*args, weight, bias, **conv)
    torch.cuda.synchronize()
    err = dcn_bf16_check(torch, dc, args, weight, out, ref, pre, what, **conv)
    return err, float((out.float() - b4.float()).abs().max()), bool(torch.equal(out, b4))


def dcn_alltaps_kernel_phase(torch, dc, peaks):
    """K4 (the per-tap kernel's ring under its own symbol: all taps and up
    to 256 output channels of a pixel tile per block) against its plain
    version and against B4 at the 16 neck shapes, batch
    16, bf16; its time, B4's, the plain version's and the bound (that of
    B4: the same function)."""
    bw, _, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(31)
    tot = dict(ms=0.0, b4_ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0,
               max_abs_diff_b4=0.0, bitwise_equal_b4=True, per_shape={})
    for count, h, w, c_in, c_out in DCN_SHAPES:
        for train in (False, True):
            with dcn_switches(alltaps=True):
                variant = dc.forward_variant(h * w, c_in, c_out, torch.bfloat16, train)
            check(variant == 'alltaps', f'alltaps gate: {h}x{w} {c_in}->{c_out} train={train} '
                                        f'takes {variant}')
        runs, weight, bias = dcn_inputs(torch, gen, BATCH, h, w, c_in, c_out, torch.bfloat16,
                                        N_KERNEL_RUNS)
        what = f'modulated_deform_conv_alltaps bf16 {h}x{w} {c_in}->{c_out}'
        err, diff, equal = alltaps_check(torch, dc, runs[0], weight, bias, what)
        ms = cuda_ms(lambda a: dc.modulated_deform_conv_alltaps(*a, weight, bias), runs)
        with dcn_switches():
            b4_ms = cuda_ms(lambda a: dc.modulated_deform_conv(*a, weight, bias), runs)
        plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_plain(*a, weight, bias), runs[:3],
                           warmup=1)
        pixels = BATCH * h * w
        n_bytes = 2 * (pixels * (c_in + 27 + c_out) + 9 * c_in * c_out + c_out)
        n_flops = 2 * pixels * 9 * c_in * c_out
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_flops / bf16_peak * 1e3
        shape = dict(count=count, x=[BATCH, h, w, c_in], c_out=c_out, ms=ms, b4_ms=b4_ms,
                     plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                     bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                     max_abs_err=err, max_abs_diff_b4=diff, bitwise_equal_b4=equal,
                     tflops=n_flops / (ms * 1e-3) / 1e12)
        tot['per_shape'][f'{h}x{w} {c_in}->{c_out}'] = shape
        for key, v in (('ms', ms), ('b4_ms', b4_ms), ('plain_ms', plain_ms),
                       ('bytes_ms', bytes_ms), ('ops_ms', ops_ms)):
            tot[key] += count * v
        tot['max_abs_err'] = max(tot['max_abs_err'], err)
        tot['max_abs_diff_b4'] = max(tot['max_abs_diff_b4'], diff)
        tot['bitwise_equal_b4'] = tot['bitwise_equal_b4'] and equal
        emit('dcn_alltaps_kernel', kernel='modulated_deform_conv_alltaps', dtype='bf16',
             tolerance='one bf16 ulp of the plain pre-bias output + one of the output + '
                       '2 n 2^-23 sum|terms|', bytes=n_bytes, flops=n_flops, **shape)
        del runs
    tot['bound_ms'] = max(tot['bytes_ms'], tot['ops_ms'])
    tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
    emit('dcn_alltaps_kernel_per_forward', dtype='bf16', dcn_launches=DCN_PER_FORWARD,
         **{k: v for k, v in tot.items() if k != 'per_shape'})
    return tot


def dcn_alltaps_edge_phase(torch, dc):
    """K4 on what the neck shapes do not reach, against its plain version
    and B4: samples wholly outside, on -1, H - 1 and H, C_out not a
    multiple of 8 (scalar weight loads) and past 256 (two column groups),
    C_in not a multiple of 8 (scalar gathers), batch 1, stride 2, dilation
    2, an unaligned x; and the wrapper's refusal of f32."""
    gen = torch.Generator(device='cuda').manual_seed(32)
    bf16 = torch.bfloat16
    cases, equal = [], []
    for name, (b, h, w, c_in, c_out), conv, off_std, far in (
            ('offsets of 20-40 px: wholly outside, output = bias', (2, 10, 14, 64, 64), {}, 0.0,
             1.0),
            ('C_out 70: two tiles, scalar weight loads', (2, 7, 9, 64, 70), {}, 2.0, 0.05),
            ('C_out 320: two column groups', (1, 9, 15, 64, 320), {}, 2.0, 0.05),
            ('C_in 33: scalar gathers, C_out 5', (2, 7, 9, 33, 5), {}, 3.0, 0.05),
            ('batch 1, 135 px, C_out 192', (1, 9, 15, 128, 192), {}, 2.0, 0.05),
            ('stride 2', (2, 10, 14, 64, 64), dict(stride=2), 2.0, 0.05),
            ('dilation 2', (2, 10, 14, 64, 64), dict(padding=2, dilation=2), 2.0, 0.05)):
        ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                              conv.get('dilation', 1))
        runs, weight, bias = dcn_inputs(torch, gen, b, h, w, c_in, c_out, bf16, 1, ho=ho, wo=wo,
                                        off_std=off_std, far=far)
        _, _, eq = alltaps_check(torch, dc, runs[0], weight, bias, f'alltaps edge {name}', **conv)
        cases.append(name)
        equal.append(eq)
    runs, weight, bias = dcn_inputs(torch, gen, 1, 6, 7, 64, 64, bf16, 1, off_std=0.0, far=0.0)
    x, off, mask = runs[0]
    off = off.float()
    off[0, 0, 0, 0::2] = torch.tensor([0, 0, 0, -1, 0, 0, 6, 5, 4.0], device='cuda')
    off[0, 3, 3, 1::2] = torch.tensor([-3, 3.5, 2, -1, 0, 0, 0.5, 0, 0], device='cuda')
    _, _, eq = alltaps_check(torch, dc, (x, off.to(bf16), mask), weight, bias, 'alltaps edge -1/H')
    cases.append('samples on -1, H - 1 and H')
    equal.append(eq)
    shifted = torch.empty(x.numel() + 1, dtype=bf16, device='cuda')[1:].view(x.shape)
    shifted.copy_(x)
    _, _, eq = alltaps_check(torch, dc, (shifted, off.to(bf16), mask), weight, bias,
                             'alltaps edge unaligned x')
    cases.append('x base off 16-byte alignment')
    equal.append(eq)
    try:
        dc.modulated_deform_conv_alltaps(x.float(), off, mask.float(), weight.float(),
                                         bias.float())
    except TypeError:
        pass
    else:
        fail('modulated_deform_conv_alltaps took float32 instead of raising TypeError')
    emit('dcn_alltaps_edges', ok=True, cases=cases, bitwise_equal_b4=equal,
         refused=['float32'])


# the proj DCNs of the neck (C_out < C_in): those the premul variant takes
DCN_PROJ_SHAPES = tuple(s for s in DCN_SHAPES if s[4] < s[3])


def premul_check(torch, dc, args, weight, bias, what, **conv):
    """K6 against its plain lerp-accumulate on the same table (bit for
    bit), and the whole premul op (cuBLAS table + K6) against its plain
    version: at least 99% of the elements within 2 bf16 ulps and every one
    within 3% of max|out| (the JAX package's gate for two bf16 DCN
    formulations; the cuBLAS table may differ from the plain one by an ulp
    where the two sum C_in products in other orders). Returns (share within
    2 ulps, max abs err of the op)."""
    kh, kw = weight.shape[:2]
    y = dc.premul_table(args[0], weight)
    out = dc.premul_lerp_accumulate(y, *args[1:], bias, (kh, kw), **conv)
    ref = dc.premul_lerp_accumulate_plain(y, *args[1:], bias, (kh, kw), **conv)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16,
          f'{what}: {tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} {ref.dtype}')
    if not torch.equal(out, ref):
        diff = (out.float() - ref.float()).abs()
        fail(f'{what}: the lerp-accumulate kernel differs from its plain version on the same '
             f'table at {int((diff > 0).sum())} elements, max {float(diff.max())}')
    op = dc.modulated_deform_conv_premul(*args, weight, bias, **conv)
    plain = dc.modulated_deform_conv_premul_plain(*args, weight, bias, **conv)
    err = (op.float() - plain.float()).abs()
    share = float((err <= 2 * bf16_ulp(plain.float())).float().mean())
    max_err = float(err.max())
    check(share >= 0.99 and max_err <= 0.03 * float(plain.float().abs().max()) + 1e-6,
          f'{what}: the premul op against its plain version: {share:.4f} of the elements within '
          f'2 bf16 ulps, max abs err {max_err}')
    return share, max_err


def dcn_premul_kernel_phase(torch, dc, peaks):
    """K6 against its plain lerp-accumulate (bits) and the premul op against
    its plain version at the 8 proj shapes of the neck, batch 16, bf16; the
    time of the table's matmul, of K6, of the op, of B4 on the same shapes,
    of K6's plain version (on the same tables) and of the op's, and K6's
    bound (bytes)."""
    bw, f32_peak, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(33)
    tot = dict(ms=0.0, graph_ms=0.0, table_ms=0.0, op_ms=0.0, b4_ms=0.0, plain_ms=0.0,
               op_plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, table_bound_ms=0.0, max_abs_err=0.0,
               min_share_2ulp=1.0, per_shape={})
    for count, h, w, c_in, c_out in DCN_PROJ_SHAPES:
        with dcn_switches(premul=True):
            variant = dc.forward_variant(h * w, c_in, c_out, torch.bfloat16)
            check(variant == 'premul', f'premul gate: {h}x{w} {c_in}->{c_out} takes {variant}')
            train_variant = dc.forward_variant(h * w, c_in, c_out, torch.bfloat16, train=True)
            check(train_variant == 'per_tap', f'premul gate: {h}x{w} {c_in}->{c_out} train '
                                              f'takes {train_variant}')
        runs, weight, bias = dcn_inputs(torch, gen, BATCH, h, w, c_in, c_out, torch.bfloat16,
                                        N_KERNEL_RUNS)
        what = f'premul bf16 {h}x{w} {c_in}->{c_out}'
        share, err = premul_check(torch, dc, runs[0], weight, bias, what)
        tables = [dc.premul_table(a[0], weight) for a in runs]
        table_ms = cuda_ms(lambda a: dc.premul_table(a[0], weight), runs)
        ms = cuda_ms(lambda i: dc.premul_lerp_accumulate(tables[i], *runs[i][1:], bias),
                     list(range(len(runs))))
        dev_ms = graph_ms(lambda i: dc.premul_lerp_accumulate(tables[i], *runs[i][1:], bias),
                          list(range(min(4, len(runs)))))
        plain_ms = cuda_ms(lambda i: dc.premul_lerp_accumulate_plain(tables[i], *runs[i][1:],
                                                                     bias), [0, 1, 2], warmup=1)
        del tables
        op_ms = cuda_ms(lambda a: dc.modulated_deform_conv_premul(*a, weight, bias), runs)
        with dcn_switches():
            b4_ms = cuda_ms(lambda a: dc.modulated_deform_conv(*a, weight, bias), runs)
        op_plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_premul_plain(*a, weight, bias),
                              runs[:3], warmup=1)
        pixels = BATCH * h * w
        # K6: the table read once, offsets + mask, the output, the bias;
        # 10 f32 operations a (pixel, tap, channel): 6 products, 4 sums
        n_bytes = 2 * (pixels * 9 * c_out + pixels * 27 + pixels * c_out + c_out)
        n_flops = 10 * pixels * 9 * c_out
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_flops / f32_peak * 1e3
        table_bound = max(2 * (pixels * c_in + 9 * c_in * c_out + pixels * 9 * c_out) / bw,
                          2 * pixels * c_in * 9 * c_out / bf16_peak) * 1e3
        shape = dict(count=count, x=[BATCH, h, w, c_in], c_out=c_out, ms=ms, graph_ms=dev_ms,
                     table_ms=table_ms,
                     op_ms=op_ms, b4_ms=b4_ms, plain_ms=plain_ms, op_plain_ms=op_plain_ms,
                     bound_ms=max(bytes_ms, ops_ms), share_of_bound=max(bytes_ms, ops_ms) / ms,
                     share_of_bound_device=max(bytes_ms, ops_ms) / dev_ms,
                     bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                     table_bound_ms=table_bound, max_abs_err=err, share_within_2ulp=share,
                     lerp_accum_bitwise_equal_plain=True,
                     achieved_gbps=n_bytes / (ms * 1e-3) / 1e9)
        tot['per_shape'][f'{h}x{w} {c_in}->{c_out}'] = shape
        for key, v in (('ms', ms), ('graph_ms', dev_ms), ('table_ms', table_ms), ('op_ms', op_ms),
                       ('b4_ms', b4_ms),
                       ('plain_ms', plain_ms), ('op_plain_ms', op_plain_ms),
                       ('bytes_ms', bytes_ms), ('ops_ms', ops_ms),
                       ('table_bound_ms', table_bound)):
            tot[key] += count * v
        tot['max_abs_err'] = max(tot['max_abs_err'], err)
        tot['min_share_2ulp'] = min(tot['min_share_2ulp'], share)
        emit('dcn_premul_kernel', kernel='modulated_deform_conv_premul_accum', dtype='bf16',
             tolerance='K6 equal to its plain lerp-accumulate on the same table; the op >= 99% '
                       'within 2 bf16 ulps of its plain version, all within 3% of max|out|',
             bytes=n_bytes, flops=n_flops, **shape)
        del runs
        torch.cuda.empty_cache()
    tot['bound_ms'] = max(tot['bytes_ms'], tot['ops_ms'])
    tot['bound_by'] = 'bytes' if tot['bytes_ms'] >= tot['ops_ms'] else 'operations'
    tot['share_of_bound'] = tot['bound_ms'] / tot['ms']
    tot['share_of_bound_device'] = tot['bound_ms'] / tot['graph_ms']
    emit('dcn_premul_kernel_per_forward', dtype='bf16',
         dcn_launches=sum(s[0] for s in DCN_PROJ_SHAPES),
         **{k: v for k, v in tot.items() if k != 'per_shape'})
    return tot


def dcn_premul_edge_phase(torch, dc):
    """K6 (bits against its plain lerp-accumulate) and the premul op on
    what the proj shapes do not reach: samples wholly outside, on -1, H - 1
    and H, C_out not a multiple of 8 (scalar loads), batch 1, stride 2,
    dilation 2, a table whose base is off 16-byte alignment (scalar loads);
    and the wrapper's refusals."""
    gen = torch.Generator(device='cuda').manual_seed(34)
    bf16 = torch.bfloat16
    cases = []
    for name, (b, h, w, c_in, c_out), conv, off_std, far in (
            ('offsets of 20-40 px: wholly outside, output = bias', (2, 10, 14, 128, 64), {},
             0.0, 1.0),
            ('C_out 5: scalar loads', (2, 7, 9, 16, 5), {}, 3.0, 0.05),
            ('batch 1, 135 px, C_out 256', (1, 9, 15, 512, 256), {}, 2.0, 0.05),
            ('stride 2', (2, 10, 14, 128, 64), dict(stride=2), 2.0, 0.05),
            ('dilation 2', (2, 10, 14, 128, 64), dict(padding=2, dilation=2), 2.0, 0.05)):
        ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                              conv.get('dilation', 1))
        runs, weight, bias = dcn_inputs(torch, gen, b, h, w, c_in, c_out, bf16, 1, ho=ho, wo=wo,
                                        off_std=off_std, far=far)
        premul_check(torch, dc, runs[0], weight, bias, f'premul edge {name}', **conv)
        cases.append(name)
    runs, weight, bias = dcn_inputs(torch, gen, 1, 6, 7, 128, 64, bf16, 1, off_std=0.0, far=0.0)
    x, off, mask = runs[0]
    off = off.float()
    off[0, 0, 0, 0::2] = torch.tensor([0, 0, 0, -1, 0, 0, 6, 5, 4.0], device='cuda')
    off[0, 3, 3, 1::2] = torch.tensor([-3, 3.5, 2, -1, 0, 0, 0.5, 0, 0], device='cuda')
    off = off.to(bf16)
    premul_check(torch, dc, (x, off, mask), weight, bias, 'premul edge -1/H')
    cases.append('samples on -1, H - 1 and H')
    y = dc.premul_table(x, weight)
    shifted = torch.empty(y.numel() + 1, dtype=bf16, device='cuda')[1:].view(y.shape)
    shifted.copy_(y)
    out = dc.premul_lerp_accumulate(shifted, off, mask, bias)
    ref = dc.premul_lerp_accumulate_plain(shifted, off, mask, bias)
    check(torch.equal(out, ref), 'premul edge unaligned table: the kernel differs from its plain '
                                 'version')
    cases.append('table base off 16-byte alignment')
    for ks, pad in (((2, 2), 0), ((5, 5), 2)):  # the generic instance; 25 taps past 48 KB
        k = ks[0] * ks[1]
        ho, wo = dc.output_hw(9, 17, *ks, 1, pad, 1)
        yk = torch.randn((2, 9, 17, k * 64), generator=gen, device='cuda').to(bf16)
        offk = (2 * torch.randn((2, ho, wo, 2 * k), generator=gen, device='cuda')).to(bf16)
        maskk = torch.sigmoid(torch.randn((2, ho, wo, k), generator=gen, device='cuda')).to(bf16)
        out = dc.premul_lerp_accumulate(yk, offk, maskk, bias, ks, padding=pad)
        ref = dc.premul_lerp_accumulate_plain(yk, offk, maskk, bias, ks, padding=pad)
        check(torch.equal(out, ref), f'premul edge {k} taps: the kernel differs from its plain '
                                     f'version')
        cases.append(f'{ks[0]}x{ks[1]} kernel (the generic instance)')
    refusals = (
        ('a float32 table', TypeError, lambda: dc.premul_lerp_accumulate(y.float(), off, mask)),
        ('a table of the wrong width', ValueError,
         lambda: dc.premul_lerp_accumulate(y[..., :-1].contiguous(), off, mask)),
        ('a CPU mask', ValueError, lambda: dc.premul_lerp_accumulate(y, off, mask.cpu())),
    )
    for name, exc, fn in refusals:
        try:
            fn()
        except exc:
            continue
        fail(f'premul_lerp_accumulate took {name} instead of raising {exc.__name__}')
    emit('dcn_premul_edges', ok=True, cases=cases, refused=[r[0] for r in refusals])


def bwd_check(torch, dc, args, weight, grad, what, **conv):
    """The backward kernel against the plain backward (autograd through the
    plain forward) on the card, per gradient (dx, d_offset, d_mask, dW).
    f32: max|kernel - plain| <= 1e-4 * max|plain| (dW sums up to 491,520
    pixel products, dx up to 36 per element, in other orders: atomics on
    the card). bf16: each one's error to the f32 oracle (the plain backward
    in f32 on the same bf16-valued inputs) is at most 1.5x the bf16 plain
    backward's own, as max|err| / max|oracle| (+ 1e-6): the plain version
    rounds ds = dy . W_k^T to bf16 at the cast autograd passes through, the
    kernel keeps it in f32 (the TPU kernel's rounding point), so the two are
    not bit-comparable, and the gate is that the kernel adds no error beyond
    the bf16 noise floor. Returns (worst error, tolerance text, per-gradient
    errors)."""
    names = ('dx', 'd_offset', 'd_mask', 'd_weight')
    out = dc.modulated_deform_conv_backward(*args, weight, grad, **conv)
    ref = dc.modulated_deform_conv_backward_plain(*args, weight, grad, **conv)
    torch.cuda.synchronize()
    errs = {}
    for name, o, r, a in zip(names, out, ref, (*args, weight)):
        check(o.shape == a.shape and o.dtype == a.dtype,
              f'{what} {name}: {tuple(o.shape)} {o.dtype} for an input {tuple(a.shape)} {a.dtype}')
        check(bool(torch.isfinite(o.float()).all()), f'{what} {name}: non-finite values')
    if weight.dtype == torch.float32:
        tol = 'max|kernel - plain| <= 1e-4 * max|plain| + 1e-7, per gradient'
        for name, o, r in zip(names, out, ref):
            err = float((o - r).abs().max())
            errs[name] = err
            check(err <= 1e-4 * float(r.abs().max()) + 1e-7,
                  f'{what} {name}: max abs err {err} against max|plain| {float(r.abs().max())}')
        return max(errs.values()), tol, errs
    oracle = dc.modulated_deform_conv_backward_plain(*[a.float() for a in args], weight.float(),
                                                     grad.float(), **conv)
    tol = ('bf16: max|kernel - oracle| <= 1.5 * max|plain - oracle| + 1e-6 * max|oracle|, '
           'oracle = the f32 plain backward on the same inputs')
    for name, o, r, g in zip(names, out, ref, oracle):
        scale = float(g.abs().max()) + 1e-30
        err_k = float((o.float() - g).abs().max()) / scale
        err_p = float((r.float() - g).abs().max()) / scale
        errs[name] = dict(kernel=err_k, plain=err_p, abs=float((o.float() - r.float()).abs().max()))
        check(err_k <= 1.5 * err_p + 1e-6,
              f'{what} {name}: error to the f32 oracle {err_k} (of max|oracle|) against the plain '
              f'bf16 backward\'s {err_p}')
    return max(e['abs'] for e in errs.values()), tol, errs


# dx adds in device memory (dx_window_spill): the window design's (spilled
# corners + flushed window cells), a design without a window's (every corner
# inside the image), and 4 K C_in per output pixel (all_corners, every
# corner counted whether inside or not);
# 'kernel': the adds of the dx kernel that runs (the window design in bf16;
# in f32 every corner inside the image)
DX_ADD_KEYS = ('kernel', 'global_adds', 'spilled', 'window', 'corner_adds', 'all_corners')


def dx_adds(torch, dc, dtype, offset, h, w, c_in):
    adds = dc.dx_window_spill(offset, h, w, c_in)
    adds['kernel'] = adds['global_adds' if dtype == torch.bfloat16 else 'corner_adds']
    return adds


# the backward's kernels by the prefix of their names in a profile: dx (the
# window kernel in bf16, the warp-specialised one in f32), dW's split sums,
# their reduce
BWD_KERNEL_NAMES = {'dx': ('deform_conv_bwd_input_',),
                    'dw': ('deform_conv_bwd_weight_kernel',),
                    'dw_reduce': ('deform_conv_bwd_weight_reduce',)}


def bwd_device_ms(torch, fn, inputs):
    """Device ms per call of each backward kernel (BWD_KERNEL_NAMES) over
    fn(x) for x in inputs, from one profiler pass after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    out = {}
    for k, names in BWD_KERNEL_NAMES.items():  # per launch: the profile may drop events
        hits = [e for e in evs if any(n in e.key for n in names)]
        n = sum(e.count for e in hits)
        out[k] = sum(e.self_device_time_total for e in hits) / 1e3 / n if n else 0.0
    return out


def bwd_bounds(pixels, c_in, c_out, isz, peaks, dt):
    """The least times of the dx and dW kernels at one shape, as (bytes ms,
    operations ms) each:
    dx reads x, the offsets and mask, W and dy once and writes dx and the
    four lerp-weight gradients (f32) once, ds = dy . W_k^T its operations;
    dW reads x, the offsets and mask and dy once and writes dW (f32) once,
    sampled^T . dy its operations, 2 pixels 9 C_in C_out each."""
    bw, f32_peak, bf16_peak = peaks
    ops_ms = 2 * pixels * 9 * c_in * c_out / (f32_peak if dt == 'f32' else bf16_peak) * 1e3
    dx_bytes = isz * (pixels * (c_in + 27 + c_out) + 9 * c_in * c_out) + 4 * pixels * (c_in + 36)
    dw_bytes = isz * pixels * (c_in + 27 + c_out) + 4 * 9 * c_in * c_out
    return {'dx': (dx_bytes / bw * 1e3, ops_ms), 'dw': (dw_bytes / bw * 1e3, ops_ms)}


def bound_of(bytes_ms, ops_ms):
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def deform_bwd_kernel_phase(torch, dc, peaks):
    """The DCN backward kernels against the plain backward at the KM3D
    neck's 7 shapes, batch 16, f32 and bf16, offsets and mask as channel
    slices of one [B,Ho,Wo,27] tensor; times per shape and per training
    step (the 16 DCNs, shapes weighted by count): the whole backward by
    CUDA events, dx and dW (its split sums and their reduce) apart by device
    time from a profiler pass, each beside its own bound."""
    bw, f32_peak, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(21)
    results = {}
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0,
                   dx_ms=0.0, dw_ms=0.0, dw_reduce_ms=0.0, dx_bytes_ms=0.0, dx_ops_ms=0.0,
                   dw_bytes_ms=0.0, dw_ops_ms=0.0, max_abs_err_dx=0.0, max_abs_err_dw=0.0,
                   dx_adds=dict.fromkeys(DX_ADD_KEYS, 0), per_shape={})
        for count, h, w, c_in, c_out in DCN_SHAPES:
            runs, weight, _ = dcn_inputs(torch, gen, BATCH, h, w, c_in, c_out, dtype,
                                         N_KERNEL_RUNS)
            grads = [torch.randn((BATCH, h, w, c_out), generator=gen, device='cuda').to(dtype)
                     for _ in range(N_KERNEL_RUNS)]
            what = f'modulated_deform_conv_backward {dt} {h}x{w} {c_in}->{c_out}'
            max_err, tol, errs = bwd_check(torch, dc, runs[0], weight, grads[0], what)
            pairs = list(zip(runs, grads))
            ms = cuda_ms(lambda a: dc.modulated_deform_conv_backward(*a[0], weight, a[1]), pairs)
            plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_backward_plain(
                *a[0], weight, a[1]), pairs[:3], warmup=1)
            isz = runs[0][0].element_size()
            pixels = BATCH * h * w
            # read x, offset + mask, W and dy once; write dx, d_offset + d_mask and dW once
            n_bytes = isz * (2 * pixels * (c_in + 27) + 2 * 9 * c_in * c_out + pixels * c_out)
            n_flops = 4 * pixels * 9 * c_in * c_out  # ds = dy . W_k^T and dW
            # f32 adds into dx in device memory, counted on these offsets
            adds = dx_adds(torch, dc, dtype, runs[0][1], h, w, c_in)
            bytes_ms = n_bytes / bw * 1e3
            ops_ms = n_flops / (f32_peak if dt == 'f32' else bf16_peak) * 1e3
            dev = bwd_device_ms(torch, lambda a: dc.modulated_deform_conv_backward(
                *a[0], weight, a[1]), pairs)
            bounds = bwd_bounds(pixels, c_in, c_out, isz, peaks, dt)
            err_of = {k: (e if dt == 'f32' else e['abs']) for k, e in errs.items()}
            shape = dict(count=count, x=[BATCH, h, w, c_in], c_out=c_out, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                         bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                         dx_ms=dev['dx'], dw_ms=dev['dw'] + dev['dw_reduce'],
                         dw_reduce_ms=dev['dw_reduce'],
                         **{f'{k}_{f}': v for k in ('dx', 'dw')
                            for f, v in zip(('bound_ms', 'bound_by'), bound_of(*bounds[k]))},
                         dw_splits=dc.dw_plan(dc.dw_stages(BATCH, h, w, dtype), c_in, c_out, 9,
                                              torch.cuda.get_device_properties(0)
                                              .multi_processor_count),
                         dx_adds={k: adds[k] for k in DX_ADD_KEYS},
                         **(dict(dx_tile=adds['tile'], dx_window=adds['window_hw'])
                            if dt == 'bf16' else
                            dict(dx_tile_dy_resident_smem=dc.dx_f32_plan(c_out))),
                         max_abs_err=max_err, errors=errs,
                         tflops=n_flops / (ms * 1e-3) / 1e12)
            tot['per_shape'][f'{h}x{w} {c_in}->{c_out}'] = shape
            for key, v in (('ms', ms), ('plain_ms', plain_ms), ('bytes_ms', bytes_ms),
                           ('ops_ms', ops_ms), ('dx_ms', shape['dx_ms']),
                           ('dw_ms', shape['dw_ms']), ('dw_reduce_ms', dev['dw_reduce']),
                           ('dx_bytes_ms', bounds['dx'][0]), ('dx_ops_ms', bounds['dx'][1]),
                           ('dw_bytes_ms', bounds['dw'][0]), ('dw_ops_ms', bounds['dw'][1])):
                tot[key] += count * v
            tot['max_abs_err_dx'] = max(tot['max_abs_err_dx'], err_of['dx'])
            tot['max_abs_err_dw'] = max(tot['max_abs_err_dw'], err_of['d_weight'])
            for key in DX_ADD_KEYS:
                tot['dx_adds'][key] += count * adds[key]
            tot['max_abs_err'] = max(tot['max_abs_err'], max_err)
            emit('deform_bwd_kernel', kernel='modulated_deform_conv_backward', dtype=dt,
                 tolerance=tol, bytes=n_bytes, flops=n_flops, **shape)
            del runs, grads, pairs
            torch.cuda.empty_cache()
        tot['bound_ms'], tot['bound_by'] = bound_of(tot['bytes_ms'], tot['ops_ms'])
        for k in ('dx', 'dw'):
            tot[f'{k}_bound_ms'], tot[f'{k}_bound_by'] = bound_of(tot[f'{k}_bytes_ms'],
                                                                  tot[f'{k}_ops_ms'])
        results[dt] = tot
        emit('deform_bwd_kernel_per_step', dtype=dt, dcn_backward_launches=3 * DCN_PER_FORWARD,
             **{k: v for k, v in tot.items() if k != 'per_shape'})
    return results


def deform_bwd_edge_phase(torch, dc):
    """Backward edge cases the KM3D shapes do not reach, both dtypes:
    offsets far outside the image, a zero mask, C_in 512 at a ragged pixel
    count, ragged channel tiles, stride 2, dilation 2, C_out 320 (the f32 dx
    kernel's dy in pieces), a 7x7 kernel in f32 (its 32-pixel tiles), an
    unaligned x; and the wrapper's refusals."""
    gen = torch.Generator(device='cuda').manual_seed(22)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (b, h, w, c_in, c_out), conv, off_std, far, zero_mask in (
                ('offsets of 20-40 px: wholly outside', (2, 10, 14, 64, 32), {}, 0.0, 1.0, False),
                ('a zero mask', (2, 10, 14, 64, 32), {}, 2.0, 0.05, True),
                ('C_in 512, 77 px', (2, 7, 11, 512, 64), {}, 2.0, 0.05, False),
                ('ragged tiles: 63 px, C_in 33, C_out 70', (2, 7, 9, 33, 70), {}, 2.0, 0.05,
                 False),
                ('stride 2', (2, 10, 14, 16, 8), dict(stride=2), 2.0, 0.05, False),
                ('dilation 2', (2, 10, 14, 16, 8), dict(padding=2, dilation=2), 2.0, 0.05,
                 False),
                ('C_out 320: the f32 dx kernel\'s dy in pieces', (2, 7, 9, 64, 320), {}, 2.0,
                 0.05, False)):
            ho, wo = dc.output_hw(h, w, 3, 3, conv.get('stride', 1), conv.get('padding', 1),
                                  conv.get('dilation', 1))
            runs, weight, _ = dcn_inputs(torch, gen, b, h, w, c_in, c_out, dtype, 1,
                                         ho=ho, wo=wo, off_std=off_std, far=far)
            x, off, mask = runs[0]
            if zero_mask:
                mask = torch.zeros_like(mask)
            grad = torch.randn((b, ho, wo, c_out), generator=gen, device='cuda').to(dtype)
            bwd_check(torch, dc, (x, off, mask), weight, grad, f'edge {name} {dtype}', **conv)
            cases.append(name)
        # the dx window's edges at 13x21 (8x8 tiles clipped by Ho and Wo, every
        # window over the image's edge): offsets of exactly +-R (every corner
        # in the window), +-(R - 0.5), and +-(R + 1) (corners past it: the
        # spill into dx)
        R = dc.DX_WINDOW_RADIUS
        for name, val, spills in (('offsets of exactly +-R', R, False),
                                  ('offsets of +-(R - 0.5)', R - 0.5, False),
                                  ('offsets of +-(R + 1)', R + 1, True)):
            runs, weight, _ = dcn_inputs(torch, gen, 2, 13, 21, 64, 32, dtype, 1)
            x, off, mask = runs[0]
            sign = torch.where(torch.rand(off.shape, generator=gen, device='cuda') < 0.5, -1.0, 1.0)
            off.copy_((sign * val).to(dtype))  # in place: off stays a slice of the 27 channels
            adds = dc.dx_window_spill(off, 13, 21, 64)
            check(adds['tile'] == (8, 8) and (adds['spilled'] > 0) == spills,
                  f'edge {name}: tile {adds["tile"]}, {adds["spilled"]} spilled adds')
            grad = torch.randn((2, 13, 21, 32), generator=gen, device='cuda').to(dtype)
            bwd_check(torch, dc, (x, off, mask), weight, grad, f'edge {name} {dtype}')
            cases.append(f'{name} (13x21: clipped 8x8 tiles, windows over the edge)')
        if dtype == torch.float32:
            # a 7x7 kernel: the f32 dx kernel's 32-pixel tile (49 taps' tables);
            # the bf16 dx kernel's ds of all taps does not fit and is refused
            check(dc.dx_f32_plan(8, 49)[0] == 32, f'dx_f32_plan(8, 49) = {dc.dx_f32_plan(8, 49)}')
            x = torch.randn((2, 9, 11, 16), generator=gen, device='cuda')
            off = 2.0 * torch.randn((2, 9, 11, 98), generator=gen, device='cuda')
            mask = torch.sigmoid(torch.randn((2, 9, 11, 49), generator=gen, device='cuda'))
            weight = torch.randn((7, 7, 16, 8), generator=gen, device='cuda') / 28.0
            grad = torch.randn((2, 9, 11, 8), generator=gen, device='cuda')
            bwd_check(torch, dc, (x, off, mask), weight, grad, 'edge 7x7 f32', padding=3)
            cases.append('a 7x7 kernel (f32: 32-pixel dx tiles)')
        # a contiguous x whose base is off 16-byte alignment: scalar loads
        runs, weight, _ = dcn_inputs(torch, gen, 2, 9, 11, 64, 64, dtype, 1)
        x, off, mask = runs[0]
        shifted = torch.empty(x.numel() + 1, dtype=dtype, device='cuda')[1:].view(x.shape)
        shifted.copy_(x)
        grad = torch.randn((2, 9, 11, 64), generator=gen, device='cuda').to(dtype)
        bwd_check(torch, dc, (shifted, off, mask), weight, grad, f'edge unaligned x {dtype}')
        cases.append('x base off 16-byte alignment')
    x, off, mask = runs[0]
    refusals = (
        ('grad_out of another shape', ValueError, lambda: dc.modulated_deform_conv_backward(
            x, off, mask, weight, grad[:, :, :5])),
        ('grad_out of another dtype', TypeError, lambda: dc.modulated_deform_conv_backward(
            x, off, mask, weight, grad.float())),
        ('a CPU grad_out', ValueError, lambda: dc.modulated_deform_conv_backward(
            x, off, mask, weight, grad.cpu())),
    )
    for name, exc, fn in refusals:
        try:
            fn()
        except exc:
            continue
        fail(f'modulated_deform_conv_backward took {name} instead of raising {exc.__name__}')
    emit('deform_bwd_edges', ok=True, cases=sorted(set(cases)), refused=[r[0] for r in refusals])


def deform_module_grad_phase(torch):
    """The DCN module's gradients on the card against the CPU, f32 (TF32
    off), at the neck's widest and largest shapes, batch 2: the whole of
    ``ModulatedDeformConv`` (its offset conv, the strided offset and mask
    slices of that conv's output, the sigmoid, the autograd function around
    the forward and backward kernels), as the training step runs it.
    Well conditioned, so that a fault in that glue shows: the offset conv's
    bias puts every offset's fractional part in [0.3, 0.7] and its weights
    (output std 0.02 px) keep it inside [0.15, 0.85], so no sample's corner
    can differ between the card and the CPU. Gate: the output and every
    gradient (x, the offset conv's weight and bias, the DCN's weight and
    bias) norm-wise within 1e-4 of the CPU's (cuDNN may take an FFT
    algorithm for the offset conv in f32)."""
    import copy
    from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv, channels_last_
    gen = torch.Generator().manual_seed(27)
    errors = {}
    for _, h, w, c_in, c_out in (DCN_SHAPES[0], DCN_SHAPES[-1]):
        mod = ModulatedDeformConv(c_in, c_out)
        mod.reset_parameters(gen)
        with torch.no_grad():
            mod.Conv_0.weight.copy_(torch.randn(mod.Conv_0.weight.shape, generator=gen)
                                    * 0.02 / (9 * c_in) ** 0.5)
            whole = torch.randint(-3, 4, (18,), generator=gen).float()
            mod.Conv_0.bias[:18] = whole + 0.3 + 0.4 * torch.rand(18, generator=gen)
            mod.Conv_0.bias[18:] = torch.randn(9, generator=gen)
            mod.bias.copy_(0.1 * torch.randn(c_out, generator=gen))
        x = torch.randn((2, c_in, h, w), generator=gen)
        g = torch.randn((2, c_out, h, w), generator=gen)
        res = {}
        for device in ('cuda', 'cpu'):
            m = channels_last_(copy.deepcopy(mod).to(device))
            xi = x.to(device).contiguous(memory_format=torch.channels_last).requires_grad_()
            out = m(xi)
            (out * g.to(device)).sum().backward()
            res[device] = {'out': out.detach(), 'x': xi.grad,
                           **{n: p.grad for n, p in m.named_parameters()}}
        shape_err = {}
        for key, ref in res['cpu'].items():
            got = res['cuda'][key].cpu()
            shape_err[key] = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
        errors[f'{h}x{w} {c_in}->{c_out}'] = shape_err
        check(max(shape_err.values()) <= 1e-4,
              f'deform_module_grad {h}x{w} {c_in}->{c_out}: card and CPU differ {shape_err}')
    emit('deform_module_grad', dtype='float32', tf32=False, batch=2,
         tolerance='norm-wise ||card - cpu|| / ||cpu|| <= 1e-4 per tensor', rel_err=errors)


def build_km3d(torch, model='km3d'):
    """The published KM3D (or MonoFlex) on the card, random weights from
    seed 0, its offset convs seeded (std 2 px) and its head calibrated on 4
    images."""
    from visualdet3d_tpu_torch import entry
    from visualdet3d_tpu_torch.entry import KM3D_IMAGE_HW
    from visualdet3d_tpu_torch.testing import calibrate_head_convs, seed_offset_convs
    system = getattr(entry, f'build_{model}_system')(device='cuda')
    gen = torch.Generator().manual_seed(13)
    calib = torch.randn((4, *KM3D_IMAGE_HW, 3), generator=gen).cuda()
    seed_offset_convs(system, gen, 2.0, calib)
    calibrate_head_convs(system, calib, gen)
    return system


DCN_FORWARD_KERNELS = ('modulated_deform_conv', 'modulated_deform_conv_alltaps',
                       'modulated_deform_conv_premul_accum')


def km3d_slice_phase(torch, dc, system, dtype_name, phase='km3d_slice'):
    """KM3D.predict (or MonoFlex's) at batch 16 over distinct request
    batches; exactly 16 DCN launches per predict, all on the per-tap
    kernel (the switches are off)."""
    from visualdet3d_tpu_torch.entry import KITTI_P2, KM3D_IMAGE_HW
    system.cfg.inference_dtype = dtype_name
    gen = torch.Generator(device='cuda').manual_seed(14)
    batches = [torch.randn((BATCH, *KM3D_IMAGE_HW, 3), generator=gen, device='cuda')
               for _ in range(N_BATCHES + 1)]
    P2 = torch.as_tensor(np.tile(KITTI_P2, (BATCH, 1, 1)), device='cuda')
    system.predict(batches[0], P2)  # warm-up: cuDNN algorithm choice, cast copy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dc.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [system.predict(images, P2) for images in batches[1:]]
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    by_kernel = {k: dc.LAUNCHES[k] for k in DCN_FORWARD_KERNELS}
    launches = by_kernel['modulated_deform_conv']
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(by_kernel == {'modulated_deform_conv': DCN_PER_FORWARD * N_BATCHES,
                        'modulated_deform_conv_alltaps': 0,
                        'modulated_deform_conv_premul_accum': 0},
          f'{phase} {dtype_name}: DCN launches {by_kernel} for {N_BATCHES} predict calls '
          f'(expected {DCN_PER_FORWARD} per call on the per-tap kernel)')
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 32, 11) and o['scores'].shape == (BATCH, 32),
              f'km3d {dtype_name}: output shapes {o["bboxes"].shape} {o["scores"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()), f'km3d {dtype_name}: non-finite {key}')
    check(min(n_valid) > 0, f'km3d {dtype_name}: a batch with no valid detection {n_valid}')

    P21 = P2[:1]
    ones = [images[:1].clone() for images in batches]
    system.predict(ones[0], P21)
    lats = []
    for i in range(N_BS1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        system.predict(ones[i % len(ones)], P21)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t) * 1e3)
    result = dict(dtype=dtype_name, batch=BATCH, image_hw=list(KM3D_IMAGE_HW),
                  ms_per_batch=ms_batch, fps=BATCH / ms_batch * 1e3,
                  bs1_p50_ms=statistics.median(lats), bs1_ms=lats,
                  valid_per_batch=n_valid, launches=launches,
                  launches_per_predict=launches / N_BATCHES, peak_memory_gb=peak_gb)
    emit(phase, **result)
    return result, batches[1], P2


def km3d_profile_phase(torch, system, images, P2, dtype_name, phase='km3d_profile'):
    """Device time by op and kernel for one batch-16 KM3D (or MonoFlex)
    predict, the busy share, and the DCN kernel's share of the device
    time."""
    system.cfg.inference_dtype = dtype_name
    system.predict(images, P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(images, P2))
    dcn = [e for e in kernels if 'deform_conv_kernel' in e.key]
    dcn_ms = sum(e.self_device_time_total for e in dcn) / 1e3
    check(sum(e.count for e in dcn) == DCN_PER_FORWARD,
          f'km3d profile: {sum(e.count for e in dcn)} DCN kernels in one predict')
    emit(phase, dtype=dtype_name, wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, dcn_kernel_ms=dcn_ms,
         dcn_share_of_device=dcn_ms / device_ms, top_ops=top_events(ops, 12),
         top_kernels=top_events(kernels, 12))


def km3d_parity_phase(torch, system, model='km3d', make=None):
    """Batch 1, f32, TF32 off: the card's KM3D (or MonoFlex) against the
    same weights on the CPU. The same valid set and labels; 2D boxes, dimensions and alpha
    within rtol = atol = 1e-3 and the 3D centre within rtol 1e-2 (cuDNN and
    oneDNN sum the convs in different orders; the centre comes from a 3x3
    least-squares solve and a division by depth); raw maps within 1e-3 of
    their largest value. ``make(device)`` builds the CPU system (default:
    ``entry.build_<model>_system``)."""
    from visualdet3d_tpu_torch import entry
    from visualdet3d_tpu_torch.entry import KITTI_P2, KM3D_IMAGE_HW
    system.cfg.inference_dtype = 'float32'
    make = make or (lambda device: getattr(entry, f'build_{model}_system')(device=device))
    cpu = make('cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    rng = np.random.default_rng(15)
    image = torch.from_numpy(rng.standard_normal((1, *KM3D_IMAGE_HW, 3)).astype(np.float32))
    P2 = torch.from_numpy(KITTI_P2[None])
    out_gpu = {k: v.cpu() for k, v in system.predict(image, P2).items()}
    raw_gpu = {k: v.float().cpu() for k, v in system.predict_raw(image).items()}
    out_cpu = cpu.predict(image, P2)
    raw_cpu = cpu.predict_raw(image)
    raw_err = {k: float((raw_gpu[k] - raw_cpu[k]).abs().max() / raw_cpu[k].abs().max())
               for k in raw_cpu}
    check(max(raw_err.values()) <= 1e-3, f'{model} parity: raw maps differ {raw_err}')
    valid = out_cpu['valid']
    n_valid = int(valid.sum())
    check(n_valid > 0, f'{model} parity: no valid detection at batch 1')
    check(torch.equal(out_gpu['valid'], valid),
          f'{model} parity: valid sets differ: gpu {out_gpu["valid"].nonzero().tolist()} '
          f'cpu {valid.nonzero().tolist()}')
    check(torch.equal(out_gpu['labels'][valid], out_cpu['labels'][valid]),
          f'{model} parity: labels differ')
    g, c = out_gpu['bboxes'][valid], out_cpu['bboxes'][valid]
    other = [i for i in range(11) if i not in (4, 5, 6)]
    box_ok = torch.allclose(g[:, other], c[:, other], rtol=1e-3, atol=1e-3)
    centre_ok = torch.allclose(g[:, 4:7], c[:, 4:7], rtol=1e-2, atol=1e-3)
    box_err = float((g[:, other] - c[:, other]).abs().max())
    centre_rel = float(((g[:, 4:7] - c[:, 4:7]).abs() / c[:, 4:7].abs().clamp_min(1e-3)).max())
    check(box_ok and centre_ok, f'{model} parity: boxes differ by up to {box_err}, '
                                f'centres by {centre_rel} relative')
    emit(f'{model}_parity', batch=1, dtype='float32', tf32=False, n_valid=n_valid,
         max_box_abs_err=box_err, max_centre_rel_err=centre_rel, raw_rel_err=raw_err,
         max_score_abs_err=float((out_gpu['scores'] - out_cpu['scores']).abs().max()))


# setting of the switches -> (dcn_switches arguments, launches per predict of
# the per-tap, all-taps and premul kernels)
DCN_VARIANT_SETTINGS = {
    'off': ({}, (16, 0, 0)),
    'alltaps': ({'alltaps': True}, (0, 16, 0)),
    'premul': ({'premul': True}, (8, 0, 8)),
    'both': ({'alltaps': True, 'premul': True}, (0, 8, 8)),
}
DCN_KERNEL_NAMES = {'modulated_deform_conv': 'deform_conv_kernel<',
                    'modulated_deform_conv_alltaps': 'deform_conv_alltaps_kernel<',
                    'modulated_deform_conv_premul_accum': 'premul_lerp_accum_kernel<'}


def km3d_dcn_variants_phase(torch, dc, system):
    """KM3D.predict in bf16 at batch 16, 384x1280, under the four settings
    of the switches (off, all-taps, premul, both), each over the same
    N_BATCHES distinct request batches: ms per batch, fps, batch-1 p50, the
    launches per predict of each DCN forward kernel (16/0/0, 0/16/0, 8/0/8,
    0/8/8 for per-tap/all-taps/premul), and a profile of one predict with
    the DCN kernels' share of the device time."""
    from visualdet3d_tpu_torch.entry import KITTI_P2, KM3D_IMAGE_HW
    system.cfg.inference_dtype = 'bfloat16'
    gen = torch.Generator(device='cuda').manual_seed(35)
    batches = [torch.randn((BATCH, *KM3D_IMAGE_HW, 3), generator=gen, device='cuda')
               for _ in range(N_BATCHES + 1)]
    P2 = torch.as_tensor(np.tile(KITTI_P2, (BATCH, 1, 1)), device='cuda')
    ones = [images[:1].clone() for images in batches]
    results = {}
    for setting, (switches, expected) in DCN_VARIANT_SETTINGS.items():
        with dcn_switches(**switches):
            system.predict(batches[0], P2)  # warm-up
            torch.cuda.synchronize()
            dc.reset_launch_counts()
            t0 = time.perf_counter()
            outs = [system.predict(images, P2) for images in batches[1:]]
            torch.cuda.synchronize()
            ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
            launches = {k: dc.LAUNCHES[k] for k in DCN_FORWARD_KERNELS}
            per_predict = tuple(launches[k] / N_BATCHES for k in DCN_FORWARD_KERNELS)
            check(per_predict == expected,
                  f'km3d_dcn_variants {setting}: launches per predict {per_predict} of '
                  f'{DCN_FORWARD_KERNELS} (expected {expected})')
            n_valid = [int(o['valid'].sum()) for o in outs]
            check(min(n_valid) > 0 and all(bool(torch.isfinite(o['bboxes']).all()) for o in outs),
                  f'km3d_dcn_variants {setting}: valid detections {n_valid} or non-finite boxes')
            system.predict(ones[0], P2[:1])
            lats = []
            for i in range(N_BS1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                system.predict(ones[i % len(ones)], P2[:1])
                torch.cuda.synchronize()
                lats.append((time.perf_counter() - t) * 1e3)
            wall_ms, kernels, ops, device_ms = device_profile(
                torch, lambda: system.predict(batches[1], P2))
        dcn_ms = {k: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
                  for k, name in DCN_KERNEL_NAMES.items()}
        dcn_calls = {k: sum(e.count for e in kernels if name in e.key)
                     for k, name in DCN_KERNEL_NAMES.items()}
        check(tuple(dcn_calls[k] for k in DCN_FORWARD_KERNELS) == expected,
              f'km3d_dcn_variants {setting} profile: DCN kernels in one predict {dcn_calls}')
        results[setting] = dict(
            setting=setting, dtype='bfloat16', batch=BATCH, image_hw=list(KM3D_IMAGE_HW),
            ms_per_batch=ms_batch, fps=BATCH / ms_batch * 1e3,
            bs1_p50_ms=statistics.median(lats), valid_per_batch=n_valid, launches=launches,
            launches_per_predict=dict(zip(DCN_FORWARD_KERNELS, per_predict)),
            profile_wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
            dcn_kernel_ms=dcn_ms, dcn_share_of_device=sum(dcn_ms.values()) / device_ms,
            top_kernels=top_events(kernels, 10))
        emit('km3d_dcn_variants', **results[setting])
    del batches, ones
    return results


def km3d_dcn_variants_parity_phase(torch, system):
    """Batch 1, bf16, both switches set: the card's KM3D (K4 at the node
    DCNs, cuBLAS + K6 at the proj DCNs) against the same weights on the CPU
    (the plain versions). Each raw map within a norm-wise 3e-2 of the CPU's
    (the bf16 gate of the CPU tests) or, where more, 1.5x the CPU's own bf16
    distance to its f32 forward (the bf16 noise floor; cuDNN and oneDNN
    round bf16 convs at other places); every box finite; the valid counts
    reported."""
    from visualdet3d_tpu_torch.entry import KITTI_P2, KM3D_IMAGE_HW, build_km3d_system
    cpu = build_km3d_system(device='cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    rng = np.random.default_rng(36)
    image = torch.from_numpy(rng.standard_normal((1, *KM3D_IMAGE_HW, 3)).astype(np.float32))
    P2 = torch.from_numpy(KITTI_P2[None])
    system.cfg.inference_dtype = cpu.cfg.inference_dtype = 'bfloat16'
    with dcn_switches(alltaps=True, premul=True):
        raw_gpu = {k: v.float().cpu() for k, v in system.predict_raw(image).items()}
        raw_cpu = {k: v.float() for k, v in cpu.predict_raw(image).items()}
        out_gpu = {k: v.cpu() for k, v in system.predict(image, P2).items()}
        out_cpu = cpu.predict(image, P2)
    cpu.cfg.inference_dtype = 'float32'
    raw_f32 = cpu.predict_raw(image)
    err, floor = {}, {}
    for k, ref in raw_cpu.items():
        err[k] = float((raw_gpu[k] - ref).norm() / ref.norm())
        floor[k] = float((ref - raw_f32[k]).norm() / raw_f32[k].norm())
    bad = {k: (err[k], floor[k]) for k in err if err[k] > max(3e-2, 1.5 * floor[k])}
    check(not bad, f'km3d_dcn_variants_parity: raw maps differ beyond the gate (err, floor) {bad}')
    check(bool(torch.isfinite(out_gpu['bboxes']).all()), 'km3d_dcn_variants_parity: boxes')
    emit('km3d_dcn_variants_parity', batch=1, dtype='bfloat16', switches='both',
         tolerance='norm-wise per raw map <= max(3e-2, 1.5 x the CPU bf16-to-f32 distance)',
         raw_rel_err=err, raw_rel_err_floor=floor,
         n_valid_card=int(out_gpu['valid'].sum()), n_valid_cpu=int(out_cpu['valid'].sum()))


N_TRAIN_WARMUP = 2   # warm-up steps before a timed training run
N_FALL_STEPS = 10    # steps on one repeated batch, in which the loss must fall
TRAIN_EPOCH = 10.0   # the epoch fed to the loss (rampup weight of the position terms)


def train_batches(torch, n, batch_size, image_hw, seed, model='km3d'):
    """n distinct synthetic KM3D (or MonoFlex) training batches (the ported
    target builder, numpy generator ``seed``), moved to the card before any
    timing."""
    from visualdet3d_tpu_torch import testing
    make = getattr(testing, f'{model}_training_batch')
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = make(rng, batch_size, image_hw)
        out.append({'images': torch.as_tensor(b['images'], device='cuda'),
                    'P2': torch.as_tensor(b['P2'], device='cuda'),
                    'gts': {k: torch.as_tensor(v, device='cuda') for k, v in b['gts'].items()}})
    return out


def km3d_train_phase(torch, dc, compute_dtype, model='km3d', batch_size=BATCH):
    """The KM3D (or MonoFlex) training step (``build_km3d_trainer``,
    ``build_monoflex_trainer``) at ``batch_size``, 384x1280: ms per step and
    img/s over N_BATCHES distinct batches after N_TRAIN_WARMUP warm-up
    steps, ending in ``synchronize()``; the DCN forward and backward
    launches of that run (16 forward on the per-tap kernel, 16 dx, 16 dW
    per step); peak memory; a profiler breakdown of one step; then
    N_FALL_STEPS steps on one repeated batch, in which the loss must fall;
    for MonoFlex, then one step under ``VD3D_DCN_ALLTAPS=1``, whose 16
    forward launches go to the all-taps kernel and whose backward to K7."""
    from visualdet3d_tpu_torch import entry
    from visualdet3d_tpu_torch.entry import KM3D_IMAGE_HW
    from visualdet3d_tpu_torch.testing import prepare_km3d_for_training
    name = compute_dtype or 'float32'
    phase = f'{model}_train'
    system, state, step = getattr(entry, f'build_{model}_trainer')(
        device='cuda', compute_dtype=compute_dtype, batch_size=batch_size)
    batches = train_batches(torch, N_TRAIN_WARMUP + N_BATCHES, batch_size, KM3D_IMAGE_HW,
                            seed=24, model=model)
    # running statistics set to the batch's, offsets of std 2 px, the head
    # calibrated: every DCN interpolates, the position solve is well posed
    prepare_km3d_for_training(system, batches[0]['images'][:4],
                              torch.Generator().manual_seed(23))
    for b in batches[:N_TRAIN_WARMUP]:
        step(b, TRAIN_EPOCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(b, TRAIN_EPOCH) for b in batches[N_TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = dict(dc.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {'modulated_deform_conv': DCN_PER_FORWARD, 'modulated_deform_conv_alltaps': 0,
                'modulated_deform_conv_premul_accum': 0,
                'modulated_deform_conv_backward_input': DCN_PER_FORWARD,
                'modulated_deform_conv_backward_weight': DCN_PER_FORWARD,
                'modulated_deform_conv_backward_weight_reduce': DCN_PER_FORWARD}
    check(launches == {k: v * N_BATCHES for k, v in per_step.items()},
          f'{phase} {name}: {launches} DCN launches for {N_BATCHES} steps (expected '
          f'{DCN_PER_FORWARD} per-tap forward, {DCN_PER_FORWARD} dx, {DCN_PER_FORWARD} dW and '
          f'{DCN_PER_FORWARD} dW reduce per step)')
    losses = [float(m['total']) for m in metrics]
    check(all(np.isfinite(losses)), f'{phase} {name}: non-finite losses {losses}')
    check(state.optimizer.count == state.step == N_TRAIN_WARMUP + N_BATCHES,
          f'{phase} {name}: {state.optimizer.count} updates in {state.step} steps')
    for p in system.net.parameters():
        check(p.dtype == torch.float32 and bool(torch.isfinite(p).all()),
              f'{phase} {name}: a master parameter is {p.dtype} or non-finite')
    for buf in system.net.buffers():
        check(not buf.is_floating_point() or buf.dtype == torch.float32,
              f'{phase} {name}: a running statistic is {buf.dtype}')

    wall_ms, kernels, ops, device_ms = device_profile(
        torch, lambda: step(batches[N_TRAIN_WARMUP], TRAIN_EPOCH))
    # each kind by its name's prefix: the dx kernel is
    # deform_conv_bwd_input_window_kernel (bf16) or deform_conv_bwd_input_ws_kernel (f32)
    prefix = {'deform_conv_kernel': ('deform_conv_kernel<', 'deform_conv_kernelI'),
              'deform_conv_bwd_input_kernel': BWD_KERNEL_NAMES['dx'],
              'deform_conv_bwd_weight_kernel': BWD_KERNEL_NAMES['dw'],
              'deform_conv_bwd_weight_reduce_kernel': BWD_KERNEL_NAMES['dw_reduce']}
    dcn = {kind: [e for e in kernels if any(p in e.key for p in prefix[kind])] for kind in prefix}
    counts = {kind: sum(e.count for e in evs) for kind, evs in dcn.items()}
    check(all(c == DCN_PER_FORWARD for c in counts.values()),
          f'{phase} {name} profile: DCN kernels in one step {counts}')
    dcn_ms = {kind: sum(e.self_device_time_total for e in evs) / 1e3 for kind, evs in dcn.items()}

    # the loss on one repeated batch falls
    fall = [float(step(batches[-1], TRAIN_EPOCH)['total']) for _ in range(N_FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f'{phase} {name}: the loss did not fall over {N_FALL_STEPS} steps on one batch: {fall}')
    alltaps = None
    if model == 'monoflex' and compute_dtype == 'bfloat16':
        # one step with the all-taps switch (bf16 DCNs): K4 forward, K7 backward
        dc.reset_launch_counts()
        with dcn_switches(alltaps=True):
            loss = float(step(batches[0], TRAIN_EPOCH)['total'])
        torch.cuda.synchronize()
        alltaps = dict(dc.LAUNCHES)
        want = dict(per_step, modulated_deform_conv=0,
                    modulated_deform_conv_alltaps=DCN_PER_FORWARD)
        check(alltaps == want and np.isfinite(loss),
              f'{phase} {name}: one step under VD3D_DCN_ALLTAPS=1 launched {alltaps} '
              f'(expected {want}), loss {loss}')
    result = dict(compute_dtype=name, batch=batch_size, image_hw=list(KM3D_IMAGE_HW),
                  ms_per_step=ms_step, img_per_s=batch_size / ms_step * 1e3, losses=losses,
                  launches=launches, launches_per_step={k: v / N_BATCHES for k, v in launches.items()},
                  peak_memory_gb=peak_gb, profile_wall_ms=wall_ms, device_ms=device_ms,
                  device_busy_share=device_ms / wall_ms,
                  device_busy_share_of_timed_step=device_ms / ms_step, dcn_kernel_ms=dcn_ms,
                  dcn_kernels_per_step=counts,
                  dcn_share_of_device=sum(dcn_ms.values()) / device_ms,
                  loss_on_one_batch=fall, launches_of_one_alltaps_step=alltaps,
                  top_ops=top_events(ops, 14), top_kernels=top_events(kernels, 14))
    emit(phase, **result)
    del system, state, step, batches
    torch.cuda.empty_cache()
    return result


def km3d_train_parity_phase(torch):
    """One f32 training step (TF32 off) on the card against the same step on
    the CPU, same weights and batch (PARITY_TRAIN_BATCH images at 384x1280; running
    statistics set to the batch's, offset convs seeded to 0.5 px, the head
    as initialised).

    Self-calibrated, as the JAX package gates its sharded gradients: at
    random init a BN network's gradients move by percents under any
    last-bit change (the DCN's corner choice, ReLU kinks and the position
    solve turn rounding differences into gradient differences; a conv bias
    before BN has a true gradient of 0), and the card and the CPU sum the
    convs (cuDNN, oneDNN) and the DCN gradients (atomics, scatter_add) in
    other orders. The noise floor is the CPU's own gradient with the input
    images moved by up to two f32 ulps (x * (1 + 2^-22 u), u uniform in
    [-1, 1]). Gates: each loss term within max(8x the floor's difference,
    2e-4 of its value); the largest elementwise gradient difference within
    8x the floor's (and 5e-2 of the largest gradient); the norm-wise
    gradient difference over all parameters (||g_card - g_cpu|| / ||g_cpu||)
    within 3x the floor's; each of the 32 DCN leaves (the DCN weights and the
    offset convs' weights, which the aggregate gates cannot see) norm-wise
    within 4x the larger of its own floor and the all-parameter floor (the
    well-conditioned check of the DCN's gradients is
    ``deform_module_grad_phase``); the running statistics after the step within
    1e-4 of their largest value; the parameters after the Adam step within
    2.5 * lr (a first Adam step moves each element by lr * g / (|g| + eps),
    so the sign of a near-zero gradient costs up to 2 * lr).

    A first version took the CPU step on the reversed batch as the floor;
    oneDNN's CPU results hardly move under that (1e-7 norm-wise), so it
    measured no rounding noise at all."""
    from visualdet3d_tpu_torch.entry import KM3D_IMAGE_HW, build_km3d_system, build_km3d_trainer
    from visualdet3d_tpu_torch.testing import prepare_km3d_for_training
    batch = train_batches(torch, 1, PARITY_TRAIN_BATCH, KM3D_IMAGE_HW, seed=25)[0]
    gpu, gpu_state, gpu_step = build_km3d_trainer(device='cuda', batch_size=PARITY_TRAIN_BATCH)
    prepare_km3d_for_training(gpu, batch['images'], torch.Generator().manual_seed(23),
                              offset_std=0.5, calibrate_head=False)
    init = {k: v.cpu() for k, v in gpu.net.state_dict().items()}
    cpu, cpu_state, cpu_step = build_km3d_trainer(device='cpu', batch_size=PARITY_TRAIN_BATCH)
    cpu.net.load_state_dict(init)
    cpu.weights_changed()
    lr = cpu_state.optimizer.schedule(0)
    m_gpu = {k: float(v) for k, v in gpu_step(batch, TRAIN_EPOCH).items()}
    cpu_batch = {'images': batch['images'].cpu(), 'P2': batch['P2'].cpu(),
                 'gts': {k: v.cpu() for k, v in batch['gts'].items()}}
    t0 = time.perf_counter()
    m_cpu = {k: float(v) for k, v in cpu_step(cpu_batch, TRAIN_EPOCH).items()}
    cpu_s = time.perf_counter() - t0
    # the noise floor: the CPU's gradients, same weights, the images moved
    # by up to two f32 ulps
    floor_sys = build_km3d_system(device='cpu')
    floor_sys.net.load_state_dict(init)
    u = torch.rand(cpu_batch['images'].shape, generator=torch.Generator().manual_seed(26))
    moved = cpu_batch['images'] * (1 + 2.0 ** -22 * (2 * u - 1))
    loss_moved, terms_moved = floor_sys.loss(moved, cpu_batch['gts'], cpu_batch['P2'],
                                           epoch=TRAIN_EPOCH)
    loss_moved.backward()
    m_moved = {k: float(v.detach()) for k, v in terms_moved.items()}
    m_moved['total'] = float(loss_moved.detach())

    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-30) for k, v in m_cpu.items()}
    loss_floor = {k: abs(m_moved[k] - v) / max(abs(v), 1e-30) for k, v in m_cpu.items()}
    bad = {k: (loss_err[k], loss_floor[k]) for k in m_cpu
           if loss_err[k] > max(8 * loss_floor[k], 2e-4)}
    check(not bad, f'km3d_train_parity: loss terms differ beyond the floor {bad}')

    def grad(p):  # parameters the loss does not reach have no .grad
        return (torch.zeros_like(p) if p.grad is None else p.grad).detach().double().cpu()
    names = [n for n, _ in cpu.net.named_parameters()]
    g_gpu = [grad(p) for p in gpu.net.parameters()]
    g_cpu = [grad(p) for p in cpu.net.parameters()]
    g_moved = [grad(p) for p in floor_sys.net.parameters()]
    worst = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
    floor = max(float((a - b).abs().max()) for a, b in zip(g_moved, g_cpu))
    gmax = max(float(b.abs().max()) for b in g_cpu)
    den = sum(float(b.norm()) ** 2 for b in g_cpu)
    rel = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_gpu, g_cpu)) / den) ** 0.5
    rel_floor = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_moved, g_cpu)) / den) ** 0.5
    per_leaf = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)), n)
                       for a, b, n in zip(g_gpu, g_cpu, names)), reverse=True)
    check(worst <= max(8 * floor, 1e-5 * gmax) and worst <= 5e-2 * gmax and rel <= 3 * rel_floor,
          f'km3d_train_parity: gradients differ: max abs {worst} (floor {floor}, gmax {gmax}), '
          f'norm-wise {rel} (floor {rel_floor})')
    # the DCN leaves one by one (they carry a small share of the total
    # norm): each DCN weight and offset conv within 4x the larger of its own
    # floor and the all-parameter floor
    dcn_leaf = {}
    for a, b, m, n in zip(g_gpu, g_cpu, g_moved, names):
        if n.endswith('ModulatedDeformConv_0.weight') or n.endswith('ModulatedDeformConv_0.Conv_0.weight'):
            den_leaf = b.norm().clamp_min(1e-30)
            dcn_leaf[n] = (float((a - b).norm() / den_leaf), float((m - b).norm() / den_leaf))
    bad = {n: e for n, e in dcn_leaf.items() if e[0] > 4 * max(e[1], rel_floor)}
    check(len(dcn_leaf) == 2 * DCN_PER_FORWARD and not bad,
          f'km3d_train_parity: {len(dcn_leaf)} DCN leaves, these differ beyond their floor '
          f'(error, floor): {bad}')
    dcn_worst = sorted(((e / max(f, rel_floor), e, f, n) for n, (e, f) in dcn_leaf.items()),
                       reverse=True)[:4]
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for pg, pc in zip(gpu.net.parameters(), cpu.net.parameters()))
    check(param_err <= 2.5 * lr, f'km3d_train_parity: parameters after the step differ by '
                                 f'{param_err} (lr {lr})')
    stats_err = max(float((bg.cpu() - bc).abs().max() / bc.abs().max().clamp_min(1e-30))
                    for bg, bc in zip(gpu.net.buffers(), cpu.net.buffers())
                    if bg.is_floating_point())
    check(stats_err <= 1e-4, f'km3d_train_parity: running statistics differ by {stats_err}')
    emit('km3d_train_parity', batch=PARITY_TRAIN_BATCH, image_hw=list(KM3D_IMAGE_HW),
         dtype='float32', tf32=False, loss_rel_err=loss_err, loss_rel_err_floor=loss_floor,
         grad_max_abs_err=worst, grad_max_abs_err_floor=floor, grad_max=gmax,
         grad_rel_err_all=rel, grad_rel_err_all_floor=rel_floor,
         grad_rel_err_worst_leaves=per_leaf[:4],
         grad_rel_err_median_leaf=statistics.median(e for e, _ in per_leaf),
         dcn_leaf_worst_ratio_err_floor=dcn_worst,
         dcn_leaf_max_rel_err=max(e for e, _ in dcn_leaf.values()),
         param_max_abs_err=param_err, lr=lr, running_stats_rel_err=stats_err,
         cpu_step_s=cpu_s, total=m_gpu['total'])


# ---------------------------------------------------------------------------
# int8 inference (slice 4): the int8 conv kernel (B8, also the K9 probes) and
# the fused int8 BasicBlock kernel (K8)
# ---------------------------------------------------------------------------

INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)


def int8_peak(part):
    return INT8_TOPS if part == 'SXM' else 1513e12  # the PCIe part's dense int8 peak


def int8_conv_shapes(torch, system, batch):
    """The conv shapes of one int8 predict (every ``Int8Conv2d`` of the int8
    copy without fused blocks), with their counts per predict, from hooks."""
    from visualdet3d_tpu_torch.models.quant import Int8Conv2d
    system.cfg.inference_dtype = 'int8'
    system.cfg.int8_block = None
    net = system.inference_net()
    seen = {}
    handles = []
    for mod in net.modules():
        if isinstance(mod, Int8Conv2d):
            def pre(m, args):
                b, c, h, w = args[0].shape
                n, kh, kw, _ = m.kernel_q.shape
                key = (b, h, w, c, n, kh, kw, m.stride, m.padding, m.dilation, m.bias is not None)
                seen[key] = seen.get(key, 0) + 1
            handles.append(mod.register_forward_pre_hook(pre))
    system.predict(*batch)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    return seen


def int8_conv_check(torch, ic, xq, wq, stride, padding, dilation, bias, what):
    """B8 against its plain version on the same inputs: the s32 sums
    bit-exact; the f32 epilogue within 1e-6 relative; bf16 within one bf16
    ulp of the plain bf16 value. Returns the largest f32 abs error."""
    gen = torch.Generator(device='cuda').manual_seed(11)
    n = wq.shape[0]
    scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3 + 1e-5
    raw = ic.int8_conv2d(xq, wq, stride, padding, dilation)
    ref = ic.int8_conv2d_plain(xq, wq, stride, padding, dilation)
    torch.cuda.synchronize()
    check(raw.dtype == torch.int32 and raw.shape == ref.shape and torch.equal(raw, ref),
          f'int8_conv2d {what}: s32 sums differ from the exact sums in '
          f'{int((raw != ref).sum()) if raw.shape == ref.shape else "shape"} places')
    f32 = ic.int8_conv2d(xq, wq, stride, padding, dilation, scale, bias, torch.float32)
    f32_ref = ic.int8_conv2d_plain(xq, wq, stride, padding, dilation, scale, bias, torch.float32)
    err = (f32 - f32_ref).abs()
    check(bool((err <= 1e-6 * f32_ref.abs()).all()),
          f'int8_conv2d {what}: f32 epilogue off by {float(err.max())} (1e-6 relative)')
    bf = ic.int8_conv2d(xq, wq, stride, padding, dilation, scale, bias, torch.bfloat16)
    bf_ref = f32_ref.to(torch.bfloat16).float()
    berr = (bf.float() - bf_ref).abs()
    check(bool((berr <= bf16_ulp(bf_ref)).all()),
          f'int8_conv2d {what}: bf16 epilogue off by {float(berr.max())} (one bf16 ulp)')
    return float(err.max())


def quantize_phase_shape(torch, ic, shape, part):
    """The activation quantize kernel against its plain version on a bf16
    activation of ``shape`` (NHWC), bit-exact; its time in CUDA events
    (``ms``: the wrapper's host time shows where the device would idle) and
    in device time (``graph_ms``, CUDA graphs), the plain version's (torch's
    five elementwise passes), ``torch.quantize_per_tensor`` on an f32 copy
    (a yardstick, not the same function: it divides, rounds and clips at
    -128) and the bytes bound (2 bytes read, 1 written per element)."""
    gen = torch.Generator(device='cuda').manual_seed(17)
    xs = [(torch.randn(shape, generator=gen, device='cuda') * 3).to(torch.bfloat16)
          for _ in range(N_KERNEL_RUNS)]
    inv = torch.tensor(127 / 9.0, device='cuda')
    got, ref = ic.quantize_act(xs[0], inv), ic.quantize_act_plain(xs[0], inv)
    torch.cuda.synchronize()
    check(got.dtype == torch.int8 and torch.equal(got, ref),
          f'int8_quantize {shape}: differs from the plain version in '
          f'{int((got != ref).sum())} places')
    n = xs[0].numel()
    fn = lambda t: ic.quantize_act(t, inv)
    xf = [x.float() for x in xs[:4]]
    scale = float(1.0 / inv)
    out = dict(ms=cuda_ms(fn, xs), graph_ms=graph_ms(fn, xs[:4]),
               plain_ms=cuda_ms(lambda t: ic.quantize_act_plain(t, inv), xs),
               library_ms=graph_ms(lambda t: torch.quantize_per_tensor(t, scale, 0, torch.qint8),
                                   xf),
               bound_ms=3 * n / CARD_PEAKS[part][0] * 1e3)
    del xf
    return out


def int8_conv_kernel_phase(torch, ic, shapes, part):
    """B8 at every conv shape of the batch-16 int8 predict: bit-exact s32,
    the epilogues, its time in the main path's mode (bf16 out), the plain
    version's, a cuDNN bf16 conv of the same shape (a yardstick, not the
    same function) and the bound."""
    import torch.nn.functional as F
    bw = CARD_PEAKS[part][0]
    gen = torch.Generator(device='cuda').manual_seed(12)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops=0, bytes=0,
                 max_abs_err=0.0)
    quant = dict(ms=0.0, graph_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    quant_shapes = []
    bound_by = {'bytes': 0.0, 'operations': 0.0}
    per_shape = []
    for (b, h, w, c, n, kh, kw, stride, padding, dilation, has_bias), count in sorted(shapes.items()):
        runs = max(3, N_KERNEL_RUNS // 2)
        xs = [torch.randint(-127, 128, (b, h, w, c), generator=gen, device='cuda',
                            dtype=torch.int8) for _ in range(runs)]
        wq = torch.randint(-127, 128, (n, kh, kw, c), generator=gen, device='cuda', dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3
        bias = torch.randn((n,), generator=gen, device='cuda') if has_bias else None
        what = (f'{b}x{h}x{w}x{c}->{n} k{kh}x{kw} s{stride} p{padding} d{dilation}'
                f'{" +bias" if has_bias else ""}')
        err = int8_conv_check(torch, ic, xs[0], wq, stride, padding, dilation, bias, what)
        q = quantize_phase_shape(torch, ic, (b, h, w, c), part)
        for key in quant:
            quant[key] += count * q[key]
        quant_shapes.append(dict(shape=[b, h, w, c], per_predict=count, **q))
        emit('int8_quantize', **quant_shapes[-1])
        fn = lambda x: ic.int8_conv2d(x, wq, stride, padding, dilation, scale, bias, torch.bfloat16)
        ms = cuda_ms(fn, xs)
        plain_ms = cuda_ms(lambda x: ic.int8_conv2d_plain(x, wq, stride, padding, dilation, scale,
                                                          bias, torch.bfloat16), xs[:3], warmup=1)
        # cuDNN's bf16 conv of the same shape, channels_last (not the same function)
        xf = [x.permute(0, 3, 1, 2).to(torch.bfloat16) for x in xs]
        wf = wq.permute(0, 3, 1, 2).to(torch.bfloat16)
        bf = bias.to(torch.bfloat16) if bias is not None else None
        pad = (padding[0][0], padding[1][0])
        library_ms = cuda_ms(lambda x: F.conv2d(x, wf, bf, stride, pad, dilation), xf)
        int_mm_ms = None
        if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) and padding == ((0, 0), (0, 0)):
            # the same function's s32 sums as one library GEMM
            wt = wq.view(n, c).t().contiguous()
            int_mm_ms = cuda_ms(lambda x: torch._int_mm(x.view(-1, c), wt), xs)
        plan = ic.plan_int8_conv(b, h, w, c, n, kh, kw, tuple(stride), padding, tuple(dilation),
                                 sms=torch.cuda.get_device_properties(0).multi_processor_count)
        ho, wo = ic.output_hw(h, w, kh, kw, stride, padding, dilation)
        ops = 2 * b * ho * wo * n * kh * kw * c
        nbytes = b * h * w * c + n * kh * kw * c + b * ho * wo * n * 2 + 4 * n * (2 if has_bias else 1)
        bytes_ms, ops_ms = nbytes / bw * 1e3, ops / int8_peak(part) * 1e3
        bound = max(bytes_ms, ops_ms)
        per_shape.append(dict(shape=what, per_predict=count, ms=ms, plain_ms=plain_ms,
                              cudnn_bf16_ms=library_ms, int_mm_ms=int_mm_ms,
                              path=plan.path, plan=plan._asdict(), bound_ms=bound,
                              bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                              tops=ops / ms / 1e9, max_abs_err_f32=err))
        total['ms'] += count * ms
        total['plain_ms'] += count * plain_ms
        total['library_ms'] += count * library_ms
        total['bound_ms'] += count * bound
        total['ops'] += count * ops
        total['bytes'] += count * nbytes
        total['max_abs_err'] = max(total['max_abs_err'], err)
        bound_by['bytes' if bytes_ms >= ops_ms else 'operations'] += count * bound
        emit('int8_conv_kernel', kernel='int8_conv2d', **per_shape[-1])
        del xs, xf
    total['bound_by'] = max(bound_by, key=bound_by.get)
    total['per_shape'] = per_shape
    total['quantize'] = quant
    emit('int8_quantize_per_forward', batch=BATCH, launches_per_predict=sum(shapes.values()),
         library='torch.quantize_per_tensor on an f32 copy, device time (not the same function)',
         **quant)
    quant['per_shape'] = quant_shapes
    emit('int8_conv_kernel_per_forward', batch=BATCH, shapes=len(per_shape),
         launches_per_predict=sum(shapes.values()), **{k: v for k, v in total.items()
                                                       if k != 'per_shape'})
    return total


def int8_conv_edge_phase(torch, ic):
    """Cases the main path does not reach, and the wrapper's refusals."""
    gen = torch.Generator(device='cuda').manual_seed(13)

    def rand(shape):
        return torch.randint(-127, 128, shape, generator=gen, device='cuda', dtype=torch.int8)

    cases = [  # (name, B, H, W, C_in, C_out, k, stride, padding, dilation, bias)
        ('1x1', 2, 9, 13, 64, 64, 1, 1, ((0, 0), (0, 0)), 1, True),
        ('3x3 stride 2', 2, 17, 23, 64, 128, 3, 2, ((1, 1), (1, 1)), 1, False),
        ('1x1 stride 2', 2, 17, 23, 64, 128, 1, 2, ((0, 0), (0, 0)), 1, False),
        ('dilation 2', 2, 12, 20, 64, 64, 3, 1, ((2, 2), (2, 2)), 2, True),
        ('asymmetric padding, 2x2', 1, 10, 14, 32, 16, 2, 1, ((0, 1), (1, 0)), 1, False),
        ('C_in 72 -> 72', 2, 7, 9, 72, 72, 3, 1, ((1, 1), (1, 1)), 1, False),
        ('C_in 72 -> 144', 2, 18, 40, 72, 144, 3, 1, ((1, 1), (1, 1)), 1, True),
        ('C_out 576', 1, 18, 80, 256, 576, 3, 1, ((1, 1), (1, 1)), 1, True),
        ('C_in 12 (4-byte copies)', 2, 11, 11, 12, 24, 3, 1, ((1, 1), (1, 1)), 1, False),
        ('C_in 7 (1-byte copies)', 2, 11, 11, 7, 5, 3, 1, ((1, 1), (1, 1)), 1, True),
        ('C_in 8 (8-byte copies)', 1, 5, 6, 8, 9, 3, 2, ((1, 1), (1, 1)), 1, False),
        ('batch 1, W 1', 1, 7, 1, 64, 64, 3, 1, ((1, 1), (1, 1)), 1, False),
        ('H 1', 3, 1, 33, 64, 64, 3, 1, ((1, 1), (1, 1)), 1, False),
        ('padding wider than the image', 1, 2, 3, 64, 64, 3, 1, ((3, 3), (3, 3)), 1, False),
    ]
    # the wgmma path's edges, each with the plan it must take: split K (under
    # each epilogue: int8_conv_check runs all three), a ragged M, N = 64 and
    # N off the tile, K tails (chunks of 32 with a zero-filled tail), boxes
    # over the image's edge, and shapes the TMA unit cannot take; every
    # wgmma case whose tiles are fewer than the SMs runs with split K forced
    # too
    wgmma_cases = [  # (name, B, H, W, C_in, C_out, k, padding, dilation, path, split K)
        ('split K: 1x1 over 640 px, C_in 8192', 1, 1, 640, 8192, 64, 1, ((0, 0), (0, 0)), 1,
         'wgmma', True),
        ('split K: 3x3, 6x20 px, 1408 -> 256 (+bias)', 1, 6, 20, 1408, 256, 3,
         ((1, 1), (1, 1)), 1, 'wgmma', True),
        ('1x1 over 2560 px, C_in 576 (K9(a))', 1, 1, 2560, 576, 64, 1, ((0, 0), (0, 0)), 1,
         'wgmma', False),
        ('M off the tile: 7x9 px, 3 images, 64 -> 64', 3, 7, 9, 64, 64, 3, ((1, 1), (1, 1)), 1,
         'wgmma', False),
        ('N 64 at 72x320 (the layer1 shape, batch 2)', 2, 72, 320, 64, 64, 3, ((1, 1), (1, 1)),
         1, 'wgmma', False),
        ('N off the tile: 200', 12, 18, 80, 256, 200, 3, ((1, 1), (1, 1)), 1, 'wgmma',
         False),
        ('N 5', 2, 9, 11, 64, 5, 3, ((1, 1), (1, 1)), 1, 'wgmma', False),
        ('K tail: C_in 48 (32-byte chunks, the last half zero-filled)', 2, 17, 23, 48, 96, 3,
         ((1, 1), (1, 1)), 1, 'wgmma', False),
        ('K tail: C_in 288 (32-byte chunks)', 4, 18, 80, 288, 288, 3, ((1, 1), (1, 1)), 1,
         'wgmma', False),
        ('C_in 96 at 36x160', 4, 36, 160, 96, 96, 3, ((1, 1), (1, 1)), 1, 'wgmma', False),
        ('boxes over the edge: padding 3, dilation 2', 2, 13, 29, 128, 128, 3,
         ((3, 2), (1, 3)), 2, 'wgmma', False),
        ('cp.async: C_in 72 at 36x160', 2, 36, 160, 72, 72, 3, ((1, 1), (1, 1)), 1, 'cp_async',
         False),
        ('cp.async: C_in 16', 2, 11, 13, 16, 64, 3, ((1, 1), (1, 1)), 1, 'cp_async', False),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    forced = []
    for name, b, h, w, c, n, k, pad, d, path, split in wgmma_cases:
        plan = ic.plan_int8_conv(b, h, w, c, n, k, k, (1, 1), pad, (d, d), sms=sms)
        check(plan.path == path and (plan.split > 1) == split,
              f'int8_conv2d {name}: plan {plan}, expected the {path} path, split {split}')
        ic.reset_launch_counts()
        bias = torch.randn((n,), generator=gen, device='cuda')
        int8_conv_check(torch, ic, rand((b, h, w, c)), rand((n, k, k, c)), (1, 1), pad, (d, d),
                        bias, name)
        key = f'int8_conv2d_{path}{"_splitk" if split else ""}'
        check(ic.LAUNCHES[key] == ic.LAUNCHES['int8_conv2d'] == 3,
              f'int8_conv2d {name}: launches {ic.LAUNCHES}, expected 3 on {key}')
        if path == 'wgmma' and not split and plan.m_tiles * plan.n_tiles < sms:
            ic.reset_launch_counts()
            with int8_plan_variant(ic, 'split'):
                int8_conv_check(torch, ic, rand((b, h, w, c)), rand((n, k, k, c)), (1, 1), pad,
                                (d, d), bias, f'{name}, split K forced')
            check(ic.LAUNCHES['int8_conv2d_wgmma_splitk'] == 3,
                  f'int8_conv2d {name}, split K forced: launches {ic.LAUNCHES}')
            forced.append(name)
    for n in (70, 144):
        int8_conv_check(torch, ic, rand((2, 18, 80, 256)), rand((n, 3, 3, 256)), (1, 1),
                        ((1, 1), (1, 1)), (1, 1), None, f'N {n}')
    # a base off 16-byte alignment goes to the cp.async path
    x = rand((2, 9, 13, 64))
    shifted = torch.empty(x.numel() + 1, dtype=torch.int8, device='cuda')[1:].view(x.shape)
    shifted.copy_(x)
    ic.reset_launch_counts()
    int8_conv_check(torch, ic, shifted, rand((64, 3, 3, 64)), (1, 1), ((1, 1), (1, 1)), (1, 1),
                    None, 'unaligned input base')
    check(ic.LAUNCHES['int8_conv2d_cp_async'] == 3,
          f'int8_conv2d with an unaligned base: launches {ic.LAUNCHES}, expected the cp.async path')
    for name, b, h, w, c, n, k, s, pad, d, has_bias in cases:
        bias = torch.randn((n,), generator=gen, device='cuda') if has_bias else None
        int8_conv_check(torch, ic, rand((b, h, w, c)), rand((n, k, k, c)), (s, s), pad, (d, d),
                        bias, name)
    # +-127 everywhere at the widest K of the path (9 x 1408): the largest sums
    for sign in (1, -1):
        xq = torch.full((1, 4, 5, 1408), 127, dtype=torch.int8, device='cuda')
        wq = torch.full((8, 3, 3, 1408), 127 * sign, dtype=torch.int8, device='cuda')
        int8_conv_check(torch, ic, xq, wq, (1, 1), ((1, 1), (1, 1)), (1, 1), None, f'+-127 {sign}')
        acc = ic.int8_conv2d(xq, wq, padding=((1, 1), (1, 1)))
        check(int(acc[0, 1, 1, 0]) == sign * 9 * 1408 * 127 * 127, 'int8_conv2d: extreme sum')
    cases = [c[0] for c in wgmma_cases] + [f'{c}, split K forced' for c in forced] + \
        ['N 70, 144', 'unaligned input base'] + [c[0] for c in cases] + ['+-127 at K = 9 x 1408']
    for shape, per_channel in (((3, 5, 7, 72), True), ((1, 1, 1, 3), False), ((2, 9, 13, 64), True)):
        x = torch.randn(shape, generator=gen, device='cuda') * 40
        inv = (torch.rand((shape[-1],) if per_channel else (), generator=gen, device='cuda') + 0.5)
        for xx in (x, x.to(torch.bfloat16)):
            check(torch.equal(ic.quantize_act(xx, inv), ic.quantize_act_plain(xx, inv)),
                  f'int8_quantize {shape} {xx.dtype} per-channel {per_channel}: differs')
    # a base that is not 16-byte aligned (a slice of a larger tensor), sizes off
    # the 16-element vector, per-tensor and per-channel scales
    for n_inv, rows, offset in ((1, 1001, 1), (72, 19, 1), (1408, 3, 3), (64, 37, 5)):
        big = torch.randn((rows * n_inv + 8,), generator=gen, device='cuda') * 60
        big[3:8] = torch.tensor([0.5, 2.5, -2.5, -0.0, 1e4], device='cuda')
        inv = (torch.rand((n_inv,), generator=gen, device='cuda') + 0.5 if n_inv > 1
               else torch.ones((), device='cuda'))
        for bb in (big, big.to(torch.bfloat16)):
            xx = bb[offset:offset + rows * n_inv].view(rows, n_inv)
            check(xx.data_ptr() % 16 != 0, 'int8_quantize: the unaligned case is aligned')
            got, ref = ic.quantize_act(xx, inv), ic.quantize_act_plain(xx, inv)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f'int8_quantize {xx.dtype} base +{offset} elements, '
                  f'n_inv {n_inv}: differs in {int((got != ref).sum())} places')
    cases += ['quantize: per-channel scales, f32 and bf16, ragged sizes, saturation',
              'quantize: a base off 16-byte alignment, n_inv 1, 64, 72, 1408']

    xq, wq = rand((2, 8, 8, 64)), rand((64, 3, 3, 64))
    refusals = [
        ('non-contiguous input', lambda: ic.int8_conv2d(xq.permute(0, 2, 1, 3), wq)),
        ('float input', lambda: ic.int8_conv2d(xq.float(), wq)),
        ('uint8 weights', lambda: ic.int8_conv2d(xq, wq.to(torch.uint8))),
        ('channel mismatch', lambda: ic.int8_conv2d(xq, wq[..., :32].contiguous())),
        ('bf16 scale', lambda: ic.int8_conv2d(xq, wq, scale=torch.ones(64, device='cuda',
                                                                       dtype=torch.bfloat16),
                                              out_dtype=torch.float32)),
        ('CPU weights', lambda: ic.int8_conv2d(xq, wq.cpu())),
        ('non-contiguous quantize input', lambda: ic.quantize_act(
            torch.ones((2, 8, 8, 64), device='cuda').permute(0, 2, 1, 3), torch.ones((), device='cuda'))),
        ('int8 quantize input', lambda: ic.quantize_act(xq, torch.ones((), device='cuda'))),
        ('mismatched quantize scales', lambda: ic.quantize_act(
            torch.ones((2, 8), device='cuda'), torch.ones((3,), device='cuda'))),
    ]
    for what, call in refusals:
        try:
            call()
        except (TypeError, ValueError):
            continue
        fail(f'int8_conv2d accepted a {what}')
    emit('int8_conv_edges', ok=True, cases=cases, refused=[r[0] for r in refusals])


def int8_probe_phase(torch, ic, part):
    """The int8 probes of tools/probe_pallas_int8.py at their shapes and seeds
    (default_rng(0)), through the int8 conv kernel, bit-exact against an int64
    reference: (a) the s8 GEMM [2560, 576] x [576, 64] as a 1x1 conv over 2560
    pixels; (b) the 9-tap shifted accumulate sum_i x[m + s_i] . w_i as the
    same kernel on the concatenation of the 9 shifted slices (the concat in
    torch, timed with it); (c) the concat-576 dot, the same function, the
    kernel alone on the concatenated slices. Beside (a), torch._int_mm."""
    bw = CARD_PEAKS[part][0]
    M, K, C = 2560, 576, 64
    rng = np.random.default_rng(0)
    a_np = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b_np = rng.integers(-127, 128, (K, C), dtype=np.int8)
    R = M + 648
    x_np = rng.integers(-127, 128, (R, C), dtype=np.int8)
    w_np = rng.integers(-127, 128, (9, C, C), dtype=np.int8)
    shifts = [0, 1, 2, 322, 323, 324, 644, 645, 646]
    ref_a = a_np.astype(np.int64) @ b_np.astype(np.int64)
    ref_b = sum(x_np[s:s + M].astype(np.int64) @ w_np[i].astype(np.int64)
                for i, s in enumerate(shifts))

    a = torch.from_numpy(a_np).cuda()
    b = torch.from_numpy(b_np).cuda()
    x = torch.from_numpy(x_np).cuda()
    w576 = torch.from_numpy(np.concatenate(list(w_np), axis=0)).cuda()  # [576, 64]
    wa = b.t().contiguous().view(C, 1, 1, K)
    wb = w576.t().contiguous().view(C, 1, 1, 9 * C)

    def gemm(lhs, wt):
        return ic.int8_conv2d(lhs.view(1, 1, M, -1), wt).view(M, C)

    def taps(xx):
        return gemm(torch.cat([xx[s:s + M] for s in shifts], dim=1), wb)

    cat = torch.cat([x[s:s + M] for s in shifts], dim=1)
    outs = {'a': (gemm(a, wa), ref_a), 'b': (taps(x), ref_b), 'c': (gemm(cat, wb), ref_b)}
    torch.cuda.synchronize()
    for k, (got, ref) in outs.items():
        check(np.array_equal(got.cpu().numpy().astype(np.int64), ref),
              f'int8 probe ({k}): not bit-exact against the int64 reference')
    gen = torch.Generator(device='cuda').manual_seed(14)
    a_in = [torch.randint(-127, 128, (M, K), generator=gen, device='cuda', dtype=torch.int8)
            for _ in range(N_KERNEL_RUNS)]
    x_in = [torch.randint(-127, 128, (R, C), generator=gen, device='cuda', dtype=torch.int8)
            for _ in range(N_KERNEL_RUNS)]
    cat_in = [torch.cat([xx[s:s + M] for s in shifts], dim=1) for xx in x_in]
    ops = 2 * M * K * C
    nbytes = M * K + K * C + M * C * 4
    bound = max(nbytes / bw, ops / int8_peak(part)) * 1e3
    bound_by = 'bytes' if nbytes / bw >= ops / int8_peak(part) else 'operations'
    res = {
        'a': cuda_ms(lambda t: gemm(t, wa), a_in),
        'b': cuda_ms(taps, x_in),
        'c': cuda_ms(lambda t: gemm(t, wb), cat_in),
    }
    int_mm_ms = cuda_ms(lambda t: torch._int_mm(t, b), a_in)
    # device time alone (CUDA graphs), in turns: at this size both calls'
    # event times are mostly host time
    graph = {}
    for who in ('int_mm', 'b8', 'b8', 'int_mm'):
        fn = (lambda t: torch._int_mm(t, b)) if who == 'int_mm' else (lambda t: gemm(t, wa))
        graph.setdefault(who, []).append(graph_ms(fn, a_in[:4]))
    graph = {k: statistics.mean(v) for k, v in graph.items()}
    plain_ms = cuda_ms(lambda t: ic.int8_conv2d_plain(t.view(1, 1, M, K), wa), a_in[:3], warmup=1)
    out = dict(ms=res['a'], probe_ms=res, gops={k: ops / v / 1e6 for k, v in res.items()},
               int_mm_ms=int_mm_ms, int_mm_gops=ops / int_mm_ms / 1e6, plain_ms=plain_ms,
               graph_ms=graph['b8'], int_mm_graph_ms=graph['int_mm'],
               plan=ic.plan_int8_conv(1, 1, M, K, C, 1, 1)._asdict(),
               bound_ms=bound, bound_by=bound_by, exact=True)
    emit('int8_probe', shape=[M, K, C], **out)
    return out


@contextlib.contextmanager
def int8_plan_variant(ic, variant):
    """Every int8 conv in the block on one variant of its plan: 'plan' (as
    planned), 'split' (the wgmma path, K split wherever the tiles are fewer
    than the SMs), 'unsplit' (the wgmma path, K never split) or 'cp_async'
    (the cp.async path, the mma.sync design, for every shape)."""
    planned = ic.plan_int8_conv

    def plan(*args, **kwargs):
        if variant == 'cp_async':
            return planned(*args, **kwargs)._replace(path='cp_async')
        return planned(*args, split_k={'split': True, 'unsplit': False}.get(variant), **kwargs)
    ic.plan_int8_conv = plan
    try:
        yield
    finally:
        ic.plan_int8_conv = planned


INT8_PLAN_TURNS = ('split', 'unsplit', 'cp_async', 'plan', 'plan', 'cp_async', 'unsplit', 'split')
N_PLAN_BS1 = 30


def int8_plan_phase(torch, ic, system, batch, P2):
    """B8's plan against its alternatives on the same inputs, in turns (each
    variant twice, the mean): at K9(a) (raw s32) and at every conv shape of
    the batch-1 int8 predict (bf16 out; at batch 1 the tiles of most shapes
    do not fill the card), each conv split, unsplit and on the cp.async path,
    bit-exact under each, with CUDA events (what a caller pays: the host's
    time included) and CUDA graphs (device time); then the whole int8
    predict, every conv on its own, at batch 1 (p50 of 2 x N_PLAN_BS1 calls:
    host-bound, so noisier than the batch-16 numbers) and at batch 16 (host
    clock over N_BATCHES calls) under each variant."""
    gen = torch.Generator(device='cuda').manual_seed(15)
    left, right = batch
    one = (left[:1].clone(), right[:1].clone(), P2[:1])
    shapes = sorted(int8_conv_shapes(torch, system, one).items())
    k9a = (1, 1, 2560, 576, 64, 1, 1, (1, 1), ((0, 0), (0, 0)), (1, 1), False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    for key, count in [(k9a, 0)] + shapes:
        b, h, w, c, n, kh, kw, stride, padding, dilation, has_bias = key
        xs = [torch.randint(-127, 128, (b, h, w, c), generator=gen, device='cuda',
                            dtype=torch.int8) for _ in range(4)]
        wq = torch.randint(-127, 128, (n, kh, kw, c), generator=gen, device='cuda', dtype=torch.int8)
        bias = torch.randn((n,), generator=gen, device='cuda') if has_bias else None
        if key == k9a:
            what, fn = 'K9(a) [2560, 576] x [576, 64] s32', lambda x: ic.int8_conv2d(x, wq)
        else:
            what = (f'{b}x{h}x{w}x{c}->{n} k{kh}x{kw}{" +bias" if has_bias else ""}')
            scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3
            fn = lambda x: ic.int8_conv2d(x, wq, stride, padding, dilation, scale, bias,
                                          torch.bfloat16)
        plan = ic.plan_int8_conv(b, h, w, c, n, kh, kw, tuple(stride), padding, tuple(dilation),
                                 sms=sms)
        got = {}
        for variant in INT8_PLAN_TURNS:
            with int8_plan_variant(ic, variant):
                if variant not in got:
                    int8_conv_check(torch, ic, xs[0], wq, stride, padding, dilation, bias,
                                    f'{what} ({variant})')
                got.setdefault(variant, []).append((cuda_ms(fn, xs), graph_ms(fn, xs[:3])))
        row = dict(shape=what, per_predict_bs1=count, planned=dict(
            path=plan.path, split=plan.split, grid=plan.grid, tiles=plan.m_tiles * plan.n_tiles))
        for variant, runs in got.items():
            row[variant] = dict(ms=statistics.mean(r[0] for r in runs),
                                graph_ms=statistics.mean(r[1] for r in runs))
        per_shape.append(row)
        emit('int8_plan', **row)
        del xs
    system.cfg.inference_dtype = 'int8'
    system.cfg.int8_block = None
    predict = {}
    for variant in INT8_PLAN_TURNS:
        with int8_plan_variant(ic, variant):
            system.predict(*one)
            system.predict(left, right, P2)
            lats = []
            for _ in range(N_PLAN_BS1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                system.predict(*one)
                torch.cuda.synchronize()
                lats.append((time.perf_counter() - t) * 1e3)
            t0 = time.perf_counter()
            for _ in range(N_BATCHES):
                system.predict(left, right, P2)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / N_BATCHES
        predict.setdefault(variant, []).append((lats, ms))
    predict = {v: dict(bs1_p50_ms=statistics.median(t for r in runs for t in r[0]),
                       ms_per_batch=statistics.mean(r[1] for r in runs))
               for v, runs in predict.items()}
    out = dict(per_shape=per_shape, predict=predict)
    emit('int8_plan_predict', batch=BATCH, **predict)
    return out


def block_entry(system, path=('ResNet_0', 'layer1_0')):
    from visualdet3d_tpu_torch.models.quant import collect_block_entries
    return collect_block_entries(system.int8_quant)[path]


def int8_block_check(torch, ib, xq, w1, w2, params, what):
    """K8 against its plain version on the same inputs, f32 and bf16 out, bit
    for bit (the s32 sums are exact and every f32 operation is rounded on
    its own in the plain version's order)."""
    stats = {}
    for dt in (torch.float32, torch.bfloat16):
        got = ib.int8_basic_block(xq, w1, w2, params, dt)
        ref = ib.int8_basic_block_plain(xq, w1, w2, params, dt)
        torch.cuda.synchronize()
        d = (got.float() - ref.float()).abs()
        check(got.dtype == ref.dtype and torch.equal(got, ref),
              f'int8_basic_block {what} {dt}: differs from the plain version in '
              f'{int((d > 0).sum())} places, by up to {float(d.max())}')
        stats[str(dt).split('.')[-1]] = dict(max_abs_err=float(d.max()),
                                             positive_share=float((ref > 0).float().mean()))
    return stats


def int8_block_kernel_phase(torch, ib, system, layer1_input, part):
    """K8 at the main path's geometry (batch 16: 32 x 72 x 320 x 64) on the
    real layer1_0 entries and its real quantized input, against its plain
    version; its time, the plain version's, two cuDNN bf16 3x3 convs of the
    same shape (a yardstick, not the same function) and the bound; K8 in
    CUDA events (``ms``) and device time (``graph_ms``, CUDA graphs), bf16
    out, and in device time with f32 out."""
    import torch.nn.functional as F
    from visualdet3d_tpu_torch.ops.int8_conv import quantize_act
    bw = CARD_PEAKS[part][0]
    be = block_entry(system)
    w1, w2 = be['e1']['kernel_q'], be['e2']['kernel_q']
    params = ib.block_params(be['e1'], be['e2'], be['bn1_scale'], be['bn1_shift'],
                             be['bn2_scale'], be['bn2_shift'])
    inv = 1.0 / be['e1']['act_scale'].float()
    x_nhwc = layer1_input.permute(0, 2, 3, 1).contiguous()
    xq = quantize_act(x_nhwc, inv)
    stats = int8_block_check(torch, ib, xq, w1, w2, params, 'layer1_0 at batch 16')
    gen = torch.Generator(device='cuda').manual_seed(15)
    xs = [xq] + [quantize_act(x_nhwc * (1 + 0.05 * torch.randn((), generator=gen, device='cuda')),
                              inv) for _ in range(N_KERNEL_RUNS - 1)]
    fn = lambda t: ib.int8_basic_block(t, w1, w2, params, torch.bfloat16)
    ms, dev_ms = cuda_ms(fn, xs), graph_ms(fn, xs[:4])
    f32_ms = graph_ms(lambda t: ib.int8_basic_block(t, w1, w2, params, torch.float32), xs[:4])
    plain_ms = cuda_ms(lambda t: ib.int8_basic_block_plain(t, w1, w2, params, torch.bfloat16),
                       xs[:3], warmup=1)
    xf = [t.permute(0, 3, 1, 2).to(torch.bfloat16) for t in xs]
    wf1, wf2 = (w.permute(0, 3, 1, 2).to(torch.bfloat16) for w in (w1, w2))
    cudnn_ms = cuda_ms(lambda t: F.conv2d(F.conv2d(t, wf1, padding=1), wf2, padding=1), xf)
    b, h, w, c = xq.shape
    ops = 2 * 2 * b * h * w * 9 * c * c
    nbytes = b * h * w * c + 2 * 9 * c * c + 6 * c * 4 + b * h * w * c * 2
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / int8_peak(part) * 1e3
    plan = ib.block_plan(b, h, w, torch.cuda.get_device_properties(0).multi_processor_count)
    out = dict(shape=[b, h, w, c], ms=ms, graph_ms=dev_ms, f32_out_graph_ms=f32_ms,
               plain_ms=plain_ms, cudnn_bf16_two_convs_ms=cudnn_ms, plan=plan._asdict(),
               bound_ms=max(bytes_ms, ops_ms), bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
               bound_by='bytes' if bytes_ms >= ops_ms else 'operations', tops=ops / ms / 1e9,
               max_abs_err=stats['float32']['max_abs_err'], gate=stats)
    emit('int8_block_kernel', kernel='int8_basic_block', **out)
    return out


def int8_block_edge_phase(torch, ib, system):
    """K8 where tiles are ragged: H and W not multiples of the tile
    (``ib.TILE_H`` x ``ib.TILE_W``), one pixel taller and wider than a tile,
    a ragged last tile in both directions, exactly one tile, batch 1, W = 1,
    H = 1, bit for bit in f32 and bf16; and the wrapper's refusals."""
    be = block_entry(system)
    w1, w2 = be['e1']['kernel_q'], be['e2']['kernel_q']
    params = ib.block_params(be['e1'], be['e2'], be['bn1_scale'], be['bn1_shift'],
                             be['bn2_scale'], be['bn2_shift'])
    gen = torch.Generator(device='cuda').manual_seed(16)
    th, tw = ib.TILE_H, ib.TILE_W
    cases = [(2, 13, 45), (1, 72, 320), (1, 9, 1), (3, 1, 70), (1, 8, 32), (2, 17, 33),
             (1, th + 1, tw + 1), (2, 2 * th + 1, 2 * tw + 2), (1, th, tw), (1, 1, 1),
             (1, 3 * th - 1, 5 * tw - 3)]
    for b, h, w in cases:
        xq = torch.randint(-40, 41, (b, h, w, 64), generator=gen, device='cuda', dtype=torch.int8)
        int8_block_check(torch, ib, xq, w1, w2, params, f'{b}x{h}x{w}')
    xq = torch.randint(-40, 41, (2, 8, 8, 64), generator=gen, device='cuda', dtype=torch.int8)
    refusals = [
        ('32 channels', lambda: ib.int8_basic_block(xq[..., :32].contiguous(), w1, w2, params)),
        ('non-contiguous input', lambda: ib.int8_basic_block(xq.permute(0, 2, 1, 3), w1, w2, params)),
        ('float input', lambda: ib.int8_basic_block(xq.float(), w1, w2, params)),
        ('bf16 params', lambda: ib.int8_basic_block(xq, w1, w2, params.to(torch.bfloat16))),
        ('int8 output', lambda: ib.int8_basic_block(xq, w1, w2, params, torch.int8)),
    ]
    for what, call in refusals:
        try:
            call()
        except (TypeError, ValueError):
            continue
        fail(f'int8_basic_block accepted a {what}')
    emit('int8_block_edges', ok=True, cases=[f'{b}x{h}x{w}' for b, h, w in cases],
         refused=[r[0] for r in refusals])


def int8_slice_phase(torch, cv, ic, ib, system, mode):
    """The int8 path (``entry.build_int8_system``) at batch 16 over distinct
    request batches, ``mode`` one of 'int8' (every conv on its own),
    'int8+K8' (``int8_block='pallas'``) or 'bfloat16' (the same folded
    network in bf16, for comparison): ms per batch, fps, bs1 p50, peak
    memory, valid detections, finite outputs, and the launches of B8, K8
    and K1 in that run (the counts set to 0 just before it)."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2
    from visualdet3d_tpu_torch.models.quant import collect_block_entries, flatten_quant
    system.cfg.inference_dtype = 'bfloat16' if mode == 'bfloat16' else 'int8'
    system.cfg.int8_block = 'pallas' if mode == 'int8+K8' else None
    gen = torch.Generator(device='cuda').manual_seed(3)
    batches = [(torch.randn((BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'),
                torch.randn((BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'))
               for _ in range(N_BATCHES + 1)]
    P2 = torch.as_tensor(np.tile(KITTI_P2, (BATCH, 1, 1)), device='cuda')
    system.predict(*batches[0], P2)  # warm-up: the int8 copy, cuDNN algorithm choice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for mod in (cv, ic, ib):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [system.predict(left, right, P2) for left, right in batches[1:]]
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = {**ic.LAUNCHES,
                'int8_basic_block': ib.LAUNCHES['int8_basic_block'],
                'correlation_volume_interleaved': cv.LAUNCHES['correlation_volume_interleaved']}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_convs = len(flatten_quant(system.int8_quant))
    n_fused = sum(1 for be in collect_block_entries(system.int8_quant).values()
                  if be['e1']['kernel_q'].shape[0] == 64)
    expected = {'int8': (n_convs, 0), 'int8+K8': (n_convs - 2 * n_fused, n_fused),
                'bfloat16': (0, 0)}[mode]
    per_predict = {k: v / N_BATCHES for k, v in launches.items()}
    by_path = sum(per_predict[f'int8_conv2d_{k}'] for k in ('wgmma', 'wgmma_splitk', 'cp_async'))
    check(per_predict['correlation_volume_interleaved'] == 2
          and (per_predict['int8_conv2d'], per_predict['int8_basic_block']) == expected
          and per_predict['int8_quantize'] == sum(expected) and by_path == expected[0]
          and (mode == 'bfloat16' or per_predict['int8_conv2d_wgmma'] > 0),
          f'{mode}: launches per predict {per_predict}, expected B8/K8 {expected} (B8 on the '
          f'wgmma path among them), one quantize for each and 2 K1')
    if mode == 'int8+K8':
        check(n_fused == 3, f'{mode}: {n_fused} fused 64-channel blocks, expected layer1\'s 3')
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 32, 11) and o['scores'].shape == (BATCH, 32),
              f'{mode}: output shapes {o["bboxes"].shape} {o["scores"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()), f'{mode}: non-finite {key}')
    check(min(n_valid) > 0, f'{mode}: a batch with no valid detection {n_valid}')

    P21 = P2[:1]
    ones = [(left[:1].clone(), right[:1].clone()) for left, right in batches]
    system.predict(*ones[0], P21)
    lats = []
    for i in range(N_BS1):
        left, right = ones[i % len(ones)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        system.predict(left, right, P21)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t) * 1e3)

    system.predict(*batches[1], P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(*batches[1], P2))
    result = dict(mode=mode, batch=BATCH, image_hw=list(IMAGE_HW), ms_per_batch=ms_batch,
                  fps=BATCH / ms_batch * 1e3, bs1_p50_ms=statistics.median(lats), bs1_ms=lats,
                  valid_per_batch=n_valid, launches=launches, launches_per_predict=per_predict,
                  peak_memory_gb=peak_gb, profile_wall_ms=wall_ms, profile_device_ms=device_ms,
                  device_busy_share=device_ms / wall_ms, top_ops=top_events(ops, 12),
                  top_kernels=top_events(kernels, 12))
    emit('int8_slice', **result)
    return result, batches[1], P2


def layer1_input(torch, system, batch, P2):
    """The bf16 input of ResNet_0.layer1_0 in the int8 predict (a hook)."""
    system.cfg.inference_dtype = 'int8'
    system.cfg.int8_block = 'pallas'
    net = system.inference_net()
    got = []
    h = net.ResNet_0.layer1_0.register_forward_pre_hook(lambda m, a: got.append(a[0].clone()))
    system.predict(*batch, P2)
    h.remove()
    return got[0]


def int8_parity_phase(torch):
    """The artifact quantized once on the CPU (``build_int8_system(device=
    'cpu')``) and moved to the card: the batch-1 int8 predict on the card
    against the CPU's, self-calibrated.

    An int8 network is chaotic at the level of its quantization noise: a
    last-bit difference before a quantize flips an int8 level now and then,
    and each flip moves the next layer's inputs enough to flip more. So the
    floor is the CPU against itself on images of which 1% of the pixels
    moved by one bf16 ulp. Gates: raw outputs within 1.5x that floor (and
    within 5e-2 of their largest value, the JAX package's int8-against-f32
    bound); the valid counts within 2; of the CPU's valid boxes, the share
    the card matches (IoU > 0.7, score within 0.05, the JAX package's decode
    gate box by box) at least the floor's share less 0.1, and at least half.
    The card's int8 predict against its own f32 predict is held to the JAX
    package's 5e-2 too.
    """
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, build_int8_system, build_system
    t0 = time.perf_counter()
    cpu = build_int8_system(device='cpu')
    cpu_build_s = time.perf_counter() - t0
    gpu = build_system(device='cuda')
    gpu.net.load_state_dict({k: v.cuda() for k, v in cpu.net.state_dict().items()})
    gpu.set_int8_quant(cpu.int8_quant)
    rng = np.random.default_rng(4)
    left = torch.from_numpy(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    right = torch.from_numpy(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    moved = torch.from_numpy(rng.random(left.shape) < 0.01)
    left_moved = torch.where(moved, left.to(torch.bfloat16).float() * (1 + 2 ** -7), left)
    P2 = torch.from_numpy(KITTI_P2[None])

    def run(system, dtype, impl, images):
        system.cfg.inference_dtype, system.cfg.int8_block = dtype, impl
        raw = system.predict_raw(images, right)
        out = system.decode(*raw, P2.to(system.device), IMAGE_HW, 32, default_nms_iou_thr=0.4)
        return [t.float().cpu() for t in raw], {k: v[0].cpu() for k, v in out.items()}

    def compare(got, ref):
        (raw_g, out_g), (raw_r, out_r) = got, ref
        rel = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(raw_g, raw_r)]
        vg, vr = out_g['valid'], out_r['valid']
        bg, br = out_g['bboxes'][vg, :4], out_r['bboxes'][vr, :4]
        lt = torch.maximum(br[:, None, :2], bg[None, :, :2])
        rb = torch.minimum(br[:, None, 2:4], bg[None, :, 2:4])
        inter = (rb - lt).clamp_min(0).prod(-1)
        area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
        iou = inter / (area(br)[:, None] + area(bg)[None] - inter).clamp_min(1e-6)
        score_ok = (out_r['scores'][vr][:, None] - out_g['scores'][vg][None]).abs() < 0.05
        matched = ((iou > 0.7) & score_ok).any(1).float().mean() if len(bg) and len(br) else 0.0
        return dict(raw_rel_err_cls_reg=rel, n_valid=[int(vg.sum()), int(vr.sum())],
                    matched_share=float(matched))

    result, failures = {}, []
    for impl in (None, 'pallas'):
        name = impl or 'per_conv'
        t0 = time.perf_counter()
        ref = run(cpu, 'int8', impl, left)
        floor = compare(run(cpu, 'int8', impl, left_moved), ref)
        cpu_s = time.perf_counter() - t0
        card = compare(run(gpu, 'int8', impl, left), ref)
        result[name] = dict(card_vs_cpu=card, cpu_vs_cpu_moved=floor, cpu_s=cpu_s)
        raw_ok = all(e <= min(1.5 * f, 5e-2) for e, f in zip(card['raw_rel_err_cls_reg'],
                                                             floor['raw_rel_err_cls_reg']))
        n_g, n_c = card['n_valid']
        if not (raw_ok and n_c > 0 and abs(n_g - n_c) <= 2
                and card['matched_share'] >= max(floor['matched_share'] - 0.1, 0.5)):
            failures.append(f'{name}: card {card} against the floor {floor}')
    f32 = run(gpu, 'float32', None, left)
    int8_vs_f32 = compare(run(gpu, 'int8', None, left), f32)
    if max(int8_vs_f32['raw_rel_err_cls_reg']) > 5e-2:
        failures.append(f'int8 against f32 on the card: {int8_vs_f32}')
    emit('int8_parity', batch=1, cpu_build_s=cpu_build_s, card_int8_vs_card_f32=int8_vs_f32,
         **result)
    check(not failures, 'int8_parity: ' + '; '.join(failures))
    del gpu


# ---------------------------------------------------------------------------
# GAC monocular 3D detection (slice 12): GroundAwareYolo3D and the DCN-headed
# Yolo3D, inference and training; K3/K5/K7 at the 1024-channel stride-16 head
# ---------------------------------------------------------------------------

GAC_TRAIN_BATCH = 8  # configs/yolo3d_gac.py's batch
GAC_HEAD_DCN = (18, 80, 1024, 1024)  # the head DCN at stride 16 of 288x1280: H, W, C_in, C_out
GAC_PHASE = {'ground_aware': 'gac', 'dcn': 'yolo3d'}
# DCN forward launches per predict (and per training step) of each head
GAC_DCN_PER_FORWARD = {'ground_aware': 0, 'dcn': 1}


def gac_inputs(torch, n, batch, seed):
    """n distinct request batches of standard-normal images [batch, 288,
    1280, 3] on the card, and the KITTI P2 tiled to the batch."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2
    gen = torch.Generator(device='cuda').manual_seed(seed)
    images = [torch.randn((batch, *IMAGE_HW, 3), generator=gen, device='cuda') for _ in range(n)]
    return images, torch.as_tensor(np.tile(KITTI_P2, (batch, 1, 1)), device='cuda')


def build_gac(torch, head):
    """``entry.build_gac_system(head=...)`` on the card, random weights from
    seed 0, made ready to predict on 4 images (``prepare_mono_for_predict``:
    Yolo3D's head DCN offsets seeded to std 2 px, GAC's LookGround alpha
    0.5, the prediction convs calibrated)."""
    from visualdet3d_tpu_torch.entry import build_gac_system
    from visualdet3d_tpu_torch.testing import prepare_mono_for_predict
    system = build_gac_system(device='cuda', head=head)
    (calib,), P2 = gac_inputs(torch, 1, 4, seed=41)
    prepare_mono_for_predict(system, calib, P2, torch.Generator().manual_seed(42))
    return system


def gac_predict_run(torch, dc, system, batches, P2, want, what):
    """predict over ``batches`` with the launch counts set to 0 just
    before: (ms per batch, outputs, launches); each DCN forward kernel's
    launches must be ``want`` (per-tap, all-taps, premul) per predict."""
    dc.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [system.predict(images, P2) for images in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = {k: dc.LAUNCHES[k] for k in DCN_FORWARD_KERNELS}
    per_predict = tuple(launches[k] / len(batches) for k in DCN_FORWARD_KERNELS)
    check(per_predict == want, f'{what}: DCN launches per predict {per_predict} of '
                               f'{DCN_FORWARD_KERNELS} (expected {want})')
    return ms, outs, launches


def gac_slice_phase(torch, dc, system, head, dtype_name):
    """``predict`` of GAC (``head='ground_aware'``) or Yolo3D (``'dcn'``) at
    batch 16 over N_BATCHES distinct request batches: ms per batch, fps,
    batch-1 p50, peak memory, valid detections, the DCN forward launches
    (GAC none; Yolo3D exactly 1 per predict, on the per-tap kernel: K3 in
    bf16, K5 in f32); for Yolo3D also a run under both switches
    (``VD3D_DCN_ALLTAPS``, ``VD3D_DCN_PREMUL``), which the 1024 -> 1024
    head leaves on the per-tap kernel (premul needs C_out < C_in, all-taps
    at most 4 MiB of tap weights)."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW
    phase = f'{GAC_PHASE[head]}_slice'
    system.cfg.inference_dtype = dtype_name
    batches, P2 = gac_inputs(torch, N_BATCHES + 1, BATCH, seed=43)
    n_dcn = GAC_DCN_PER_FORWARD[head]
    want = (n_dcn, 0, 0)
    system.predict(batches[0], P2)  # warm-up: cuDNN algorithm choice, cast copy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_batch, outs, launches = gac_predict_run(torch, dc, system, batches[1:], P2, want,
                                               f'{phase} {dtype_name}')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 32, 11) and o['scores'].shape == (BATCH, 32),
              f'{phase} {dtype_name}: output shapes {o["bboxes"].shape} {o["scores"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()), f'{phase} {dtype_name}: non-finite {key}')
    check(min(n_valid) > 0, f'{phase} {dtype_name}: a batch with no valid detection {n_valid}')
    switched = None
    if n_dcn:
        with dcn_switches(alltaps=True, premul=True):
            _, _, switched = gac_predict_run(torch, dc, system, batches[1:3], P2, want,
                                             f'{phase} {dtype_name} under both switches')
    P21 = P2[:1]
    ones = [images[:1].clone() for images in batches]
    system.predict(ones[0], P21)
    lats = []
    for i in range(N_BS1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        system.predict(ones[i % len(ones)], P21)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t) * 1e3)
    result = dict(model=GAC_PHASE[head], dtype=dtype_name, batch=BATCH, image_hw=list(IMAGE_HW),
                  ms_per_batch=ms_batch, fps=BATCH / ms_batch * 1e3,
                  bs1_p50_ms=statistics.median(lats), bs1_ms=lats, valid_per_batch=n_valid,
                  launches=launches['modulated_deform_conv'], launches_by_kernel=launches,
                  launches_per_predict=launches['modulated_deform_conv'] / N_BATCHES,
                  launches_under_both_switches_2_predicts=switched, peak_memory_gb=peak_gb)
    emit(phase, **result)
    return result, batches[1], P2


def gac_profile_phase(torch, system, head, images, P2, dtype_name):
    """A profiler breakdown of one batch-16 predict: device time, the busy
    share, the top ops and kernels, ``grid_sample``'s device time (GAC) or
    the DCN kernel's (Yolo3D) and its share; and, by CUDA events on the
    inference network, the trunk alone, the head alone on the trunk's
    features (and GAC's ``LookGround`` alone), against the whole predict:
    the head's share."""
    phase = f'{GAC_PHASE[head]}_profile'
    system.cfg.inference_dtype = dtype_name
    system.predict(images, P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(images, P2))
    grid = [e for e in kernels if 'grid_sampler' in e.key]
    dcn = [e for e in kernels if 'deform_conv_kernel' in e.key]
    check(sum(e.count for e in dcn) == GAC_DCN_PER_FORWARD[head],
          f'{phase} {dtype_name}: {sum(e.count for e in dcn)} DCN kernels in one predict')
    check(bool(grid) == (head == 'ground_aware'),
          f'{phase} {dtype_name}: grid_sample kernels {[e.key for e in grid]}')
    net = system.inference_net()
    x = system._images(images, system.inference_dtype())
    with torch.inference_mode():
        feats = net.ResNet_0(x)[0]
        runs = range(5)
        trunk_ms = cuda_ms(lambda _: net.ResNet_0(x), runs, warmup=1)
        head_ms = cuda_ms(lambda _: net.head(feats, P2), runs, warmup=1)
        look_ms = (cuda_ms(lambda _: net.head.LookGround_0(feats, P2), runs, warmup=1)
                   if head == 'ground_aware' else None)
    predict_ms = cuda_ms(lambda _: system.predict(images, P2), runs, warmup=1)
    grid_ms = sum(e.self_device_time_total for e in grid) / 1e3
    dcn_ms = sum(e.self_device_time_total for e in dcn) / 1e3
    emit(phase, dtype=dtype_name, batch=BATCH, wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, grid_sample_ms=grid_ms,
         grid_sample_share_of_device=grid_ms / device_ms, dcn_kernel_ms=dcn_ms,
         dcn_share_of_device=dcn_ms / device_ms, events_predict_ms=predict_ms,
         events_trunk_ms=trunk_ms, events_head_ms=head_ms, events_look_ground_ms=look_ms,
         head_share_of_predict=head_ms / predict_ms, top_ops=top_events(ops, 12),
         top_kernels=top_events(kernels, 12))


def gac_parity_phase(torch, system, head):
    """Batch 1, f32, TF32 off: the card's GAC (or Yolo3D) against the same
    weights on the CPU, at the stereo decode gates: the same valid set and
    labels, boxes within rtol = atol = 1e-3 (cuDNN and oneDNN sum the convs
    in different orders), raw outputs within 1e-3 of their largest value."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, build_gac_system
    phase = f'{GAC_PHASE[head]}_parity'
    system.cfg.inference_dtype = 'float32'
    cpu = build_gac_system(device='cpu', head=head)
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    rng = np.random.default_rng(44)
    image = torch.from_numpy(rng.standard_normal((1, *IMAGE_HW, 3)).astype(np.float32))
    P2 = torch.from_numpy(KITTI_P2[None])
    out_gpu = {k: v.cpu() for k, v in system.predict(image, P2).items()}
    raw_gpu = [t.float().cpu() for t in system.predict_raw(image, P2)]
    out_cpu = cpu.predict(image, P2)
    raw_cpu = [t.float() for t in cpu.predict_raw(image, P2)]
    raw_err = [float((g - c).abs().max() / c.abs().max()) for g, c in zip(raw_gpu, raw_cpu)]
    check(max(raw_err) <= 1e-3, f'{phase}: raw outputs differ {raw_err}')
    valid = out_cpu['valid']
    n_valid = int(valid.sum())
    check(n_valid > 0, f'{phase}: no valid detection at batch 1')
    check(torch.equal(out_gpu['valid'], valid),
          f'{phase}: valid sets differ: gpu {out_gpu["valid"].nonzero().tolist()} '
          f'cpu {valid.nonzero().tolist()}')
    check(torch.equal(out_gpu['labels'][valid], out_cpu['labels'][valid]),
          f'{phase}: labels differ')
    box_err = float((out_gpu['bboxes'][valid] - out_cpu['bboxes'][valid]).abs().max())
    check(torch.allclose(out_gpu['bboxes'][valid], out_cpu['bboxes'][valid], rtol=1e-3,
                         atol=1e-3), f'{phase}: boxes differ by up to {box_err}')
    emit(phase, batch=1, dtype='float32', tf32=False, n_valid=n_valid, max_box_abs_err=box_err,
         raw_rel_err_cls_reg=raw_err,
         max_score_abs_err=float((out_gpu['scores'] - out_cpu['scores']).abs().max()))
    del cpu


# the bf16 forward's accumulation allowance at the head, in f32 ulps of the
# sum of the absolute tap products: mma.sync's f32 accumulator adds each
# 16-product step with the tensor core's alignment and truncation, measured
# at up to 8 such ulps at [4, 18, 80, 1024] -> 1024 and 2.7-3.5 at the KM3D
# neck's shapes (cuBLAS's f32 GEMM of the plain version: 0.25)
HEAD_DCN_ACC_ULPS = 16


def dcn_exact_f64(torch, dc, x, offset, mask, weight):
    """The exact pre-bias DCN output of the kernel's own bf16 samples and
    weights (the plain version's lerps and rounding points, the tap
    products summed in f64, where the sums of products of two bf16 values
    are exact), and the sum of the absolute tap products, both [B, Ho, Wo,
    C_out] f64 (stride 1, padding 1)."""
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    y0, x0, weights = dc._corners(offset, mask, h, w, kh, kw, 1, 1, 1, x.dtype)
    flat = x.reshape(b, h * w, c_in).float()
    wk = weight.reshape(kh * kw, c_in, c_out).double()
    exact = torch.zeros((b, h * w, c_out), dtype=torch.float64, device=x.device)
    absum = torch.zeros_like(exact)
    for k in range(kh * kw):
        sampled = dc._sample_tap(flat, y0, x0, weights, k, h, w).to(x.dtype).double()
        exact += sampled @ wk[k]
        absum += sampled.abs() @ wk[k].abs()
    return exact.reshape(b, h, w, c_out), absum.reshape(b, h, w, c_out)


def head_dcn_bf16_check(torch, dc, args, weight, bias, what):
    """K3 at the head shape against the plain version (f32 sums) and the f64
    sums of the same bf16 samples, per element: within one bf16 ulp of the
    pre-bias output and one of the output (as ``dcn_check``), plus the
    accumulation allowance HEAD_DCN_ACC_ULPS f32 ulps of the sum of the
    absolute tap products. ``dcn_check``'s premise, that only a last-bit
    sum-order difference can flip a rounding, fails where the 9216 products
    nearly cancel: there the tensor core's accumulation error is many ulps
    of the small output. Returns (max abs err to the plain version,
    tolerance text, the kernel's and the plain version's worst error to the
    f64 sums in f32 ulps of the sum of the absolute products)."""
    out = dc.modulated_deform_conv(*args, weight, bias).double()
    ref = dc.modulated_deform_conv_plain(*args, weight, bias).double()
    pre = dc.modulated_deform_conv_plain(*args, weight, None).float()
    exact, absum = dcn_exact_f64(torch, dc, *args, weight)
    torch.cuda.synchronize()
    eps = 2.0 ** -23
    allow = HEAD_DCN_ACC_ULPS * eps * absum
    tol = bf16_ulp(pre).double() + bf16_ulp(ref.float()).double() + allow
    oracle = (exact.to(torch.bfloat16) + bias).double()
    err_plain = (out - ref).abs()
    err_exact = (out - oracle).abs()
    ulps_of = lambda v: float(((v.to(torch.bfloat16).double() - exact).abs()
                               - bf16_ulp(exact.float()).double() / 2).clamp_min(0).div(
                                   (eps * absum).clamp_min(1e-30)).max())
    acc_ulps = {'kernel': ulps_of(dc.modulated_deform_conv(*args, weight, None).double()),
                'plain': ulps_of(pre.double())}
    text = (f'one bf16 ulp of the pre-bias output + one of the output + {HEAD_DCN_ACC_ULPS} f32 '
            'ulps of sum|tap products|, per element, against the f32 plain version and the f64 '
            'sums of the same bf16 samples')
    ok = bool((err_plain <= tol).all()) and bool((err_exact <= tol).all())
    check(ok, f'{what}: max abs err {float(err_plain.max())} to the plain version, '
              f'{float(err_exact.max())} to the f64 sums, outside {text}')
    return float(err_plain.max()), text, acc_ulps


def gac_head_dcn_kernel_phase(torch, dc, peaks):
    """K3/K5 (the per-tap DCN forward) and K7 (dx and dW apart) at the
    Yolo3D head's shape, [16, 18, 80, 1024] -> 1024, f32 and bf16, offsets
    seeded (std 2 px, 5% of them 20-40 px, outside the map): each against
    its plain version on the same inputs at batch 16 (``dcn_check`` in f32,
    ``head_dcn_bf16_check`` in bf16, ``bwd_check``), its time in CUDA
    events and in device time (the forward from CUDA graphs, dx and dW
    apart from a profiler pass by kernel name), its bound, a cuDNN dense 3x3
    conv of the same shape as a reference point, ``dx_f32_plan``'s tile and
    ``dw_plan``'s split."""
    import torch.nn.functional as F
    bw, f32_peak, bf16_peak = peaks
    h, w, c_in, c_out = GAC_HEAD_DCN
    gen = torch.Generator(device='cuda').manual_seed(45)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        runs, weight, bias = dcn_inputs(torch, gen, BATCH, h, w, c_in, c_out, dtype,
                                        N_KERNEL_RUNS)
        what = f'gac head modulated_deform_conv {dt} {h}x{w} {c_in}->{c_out}'
        acc_ulps = None
        if dtype == torch.bfloat16:
            fwd_err, fwd_tol, acc_ulps = head_dcn_bf16_check(torch, dc, runs[0], weight, bias,
                                                             what)
        else:
            fwd_err, fwd_tol = dcn_check(torch, dc, runs[0], weight, bias, what)
        fwd = lambda a: dc.modulated_deform_conv(*a, weight, bias)
        ms = cuda_ms(fwd, runs)
        device = graph_ms(fwd, runs[:4])  # device time: no host time in it
        plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_plain(*a, weight, bias), runs[:3],
                           warmup=1)
        w_oihw = weight.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        dense_ms = cuda_ms(lambda a: F.conv2d(a[0].permute(0, 3, 1, 2), w_oihw, bias, padding=1),
                           runs)
        isz = runs[0][0].element_size()
        pixels = BATCH * h * w
        n_bytes = isz * (pixels * (c_in + 27 + c_out) + 9 * c_in * c_out + c_out)
        n_flops = 2 * pixels * 9 * c_in * c_out
        bound_ms, bound_by = bound_of(n_bytes / bw * 1e3,
                                      n_flops / (f32_peak if dt == 'f32' else bf16_peak) * 1e3)
        # the backward
        grads = [torch.randn((BATCH, h, w, c_out), generator=gen, device='cuda').to(dtype)
                 for _ in range(N_KERNEL_RUNS)]
        bwhat = f'gac head modulated_deform_conv_backward {dt} {h}x{w} {c_in}->{c_out}'
        bwd_err, bwd_tol, errs = bwd_check(torch, dc, runs[0], weight, grads[0], bwhat)
        pairs = list(zip(runs, grads))
        bwd = lambda a: dc.modulated_deform_conv_backward(*a[0], weight, a[1])
        bwd_ms = cuda_ms(bwd, pairs)
        bwd_plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_backward_plain(
            *a[0], weight, a[1]), pairs[:2], warmup=1)
        dev = bwd_device_ms(torch, bwd, pairs)
        bounds = bwd_bounds(pixels, c_in, c_out, isz, peaks, dt)
        err_of = {k: (e if dt == 'f32' else e['abs']) for k, e in errs.items()}
        adds = dx_adds(torch, dc, dtype, runs[0][1], h, w, c_in)
        r = dict(x=[BATCH, h, w, c_in], c_out=c_out, max_abs_err=fwd_err, tolerance=fwd_tol,
                 accumulation_error_f32_ulps_of_abs_sum=acc_ulps,
                 ms=ms, device_ms=device, plain_ms=plain_ms, dense_conv_ms=dense_ms,
                 bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, flops=n_flops,
                 share_of_bound_device=bound_ms / device if device else None,
                 tflops=n_flops / (ms * 1e-3) / 1e12,
                 backward_ms_events=bwd_ms, backward_plain_ms=bwd_plain_ms,
                 backward_tolerance=bwd_tol, backward_errors=errs,
                 max_abs_err_dx=err_of['dx'], max_abs_err_dw=err_of['d_weight'],
                 dx_ms=dev['dx'], dw_ms=dev['dw'] + dev['dw_reduce'], dw_reduce_ms=dev['dw_reduce'],
                 **{f'{k}_{f}': v for k in ('dx', 'dw')
                    for f, v in zip(('bound_ms', 'bound_by'), bound_of(*bounds[k]))},
                 dw_splits=dc.dw_plan(dc.dw_stages(BATCH, h, w, dtype), c_in, c_out, 9, n_sm),
                 dx_adds={k: adds[k] for k in DX_ADD_KEYS},
                 **(dict(dx_tile=adds['tile'], dx_window=adds['window_hw']) if dt == 'bf16'
                    else dict(dx_tile_dy_resident_smem=dc.dx_f32_plan(c_out))))
        check(dt == 'bf16' or r['dx_tile_dy_resident_smem'][0] is not None,
              f'gac head dx_f32_plan({c_out}): no tile fits')
        results[dt] = r
        emit('gac_head_dcn_kernel', kernel='modulated_deform_conv + backward', dtype=dt,
             plain_batch=BATCH, **r)
        del runs, grads, pairs
        torch.cuda.empty_cache()
    return results


def gac_train_phase(torch, dc, compute_dtype, head):
    """The GAC (or Yolo3D) training step (``build_gac_trainer``) at batch 8,
    288x1280, bf16 mixed precision or f32: ms per step and img/s over
    N_BATCHES distinct batches after N_TRAIN_WARMUP warm-up steps, ending in
    ``synchronize()``; the DCN launches of that run (Yolo3D: 1 forward on
    the per-tap kernel, 1 dx, 1 dW and 1 dW reduce a step; GAC none); peak
    memory; a profiler breakdown of one step (the DCN kernels' and
    ``grid_sample``'s forward and backward device time); then N_FALL_STEPS
    steps on one repeated batch, in which the loss must fall."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import IMAGE_HW, build_gac_trainer
    from visualdet3d_tpu_torch.testing import prepare_mono_for_training
    name = compute_dtype or 'float32'
    phase = f'{GAC_PHASE[head]}_train'
    system, state, step = build_gac_trainer(device='cuda', compute_dtype=compute_dtype,
                                            batch_size=GAC_TRAIN_BATCH, head=head)
    batches = train_batches_of(torch, testing.mono_training_batch, N_TRAIN_WARMUP + N_BATCHES,
                               GAC_TRAIN_BATCH, seed=46)
    # running statistics set to the batch's; Yolo3D's offsets of std 2 px in that regime
    prepare_mono_for_training(system, batches[0]['images'][:4], batches[0]['P2'][:4],
                              torch.Generator().manual_seed(47))
    for b in batches[:N_TRAIN_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    dc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(b) for b in batches[N_TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = dict(dc.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = GAC_DCN_PER_FORWARD[head]
    per_step = {'modulated_deform_conv': n, 'modulated_deform_conv_alltaps': 0,
                'modulated_deform_conv_premul_accum': 0,
                'modulated_deform_conv_backward_input': n,
                'modulated_deform_conv_backward_weight': n,
                'modulated_deform_conv_backward_weight_reduce': n}
    check(launches == {k: v * N_BATCHES for k, v in per_step.items()},
          f'{phase} {name}: {launches} DCN launches for {N_BATCHES} steps (expected {per_step} '
          'a step)')
    losses = [float(m['total']) for m in metrics]
    check(all(np.isfinite(losses)) and min(losses) > 0, f'{phase} {name}: losses {losses}')
    check(state.optimizer.count == state.step == N_TRAIN_WARMUP + N_BATCHES,
          f'{phase} {name}: {state.optimizer.count} updates in {state.step} steps')
    for p in system.net.parameters():
        check(p.dtype == torch.float32 and bool(torch.isfinite(p).all()),
              f'{phase} {name}: a master parameter is {p.dtype} or non-finite')
    for buf in system.net.buffers():
        check(not buf.is_floating_point() or buf.dtype == torch.float32,
              f'{phase} {name}: a running statistic is {buf.dtype}')

    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: step(batches[-1]))
    prefix = {'deform_conv_kernel': ('deform_conv_kernel<', 'deform_conv_kernelI'),
              'deform_conv_bwd_input_kernel': BWD_KERNEL_NAMES['dx'],
              'deform_conv_bwd_weight_kernel': BWD_KERNEL_NAMES['dw'],
              'deform_conv_bwd_weight_reduce_kernel': BWD_KERNEL_NAMES['dw_reduce'],
              'grid_sampler': ('grid_sampler',)}
    found = {kind: [e for e in kernels if any(p in e.key for p in prefix[kind])]
             for kind in prefix}
    counts = {kind: sum(e.count for e in evs) for kind, evs in found.items()}
    check(all(counts[kind] == n for kind in prefix if kind != 'grid_sampler'),
          f'{phase} {name} profile: DCN kernels in one step {counts}')
    kernel_ms = {kind: sum(e.self_device_time_total for e in evs) / 1e3
                 for kind, evs in found.items()}

    fall = [float(step(batches[-1])['total']) for _ in range(N_FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f'{phase} {name}: the loss did not fall over {N_FALL_STEPS} steps on one batch: {fall}')
    result = dict(compute_dtype=name, batch=GAC_TRAIN_BATCH, image_hw=list(IMAGE_HW),
                  ms_per_step=ms_step, img_per_s=GAC_TRAIN_BATCH / ms_step * 1e3, losses=losses,
                  launches=launches,
                  launches_per_step={k: v / N_BATCHES for k, v in launches.items()},
                  peak_memory_gb=peak_gb, profile_wall_ms=wall_ms, device_ms=device_ms,
                  device_busy_share=device_ms / wall_ms,
                  device_busy_share_of_timed_step=device_ms / ms_step, kernel_ms=kernel_ms,
                  kernels_per_step=counts,
                  dcn_share_of_device=sum(v for k, v in kernel_ms.items()
                                          if k != 'grid_sampler') / device_ms,
                  loss_on_one_batch=fall, top_ops=top_events(ops, 14),
                  top_kernels=top_events(kernels, 14))
    emit(phase, **result)
    del system, state, step, batches
    torch.cuda.empty_cache()
    return result


# the residual branches' last BatchNorm scale in the GAC step parity: at
# flax's init (1) a random ResNet-101's gradients explode through the 30
# bottlenecks, and the f32 steps of both devices sit 3-5% from the f64 step
# (the CPU's also moves that much when the images move by two f32 ulps),
# which no gate could read; at 0.1 both are within 0.5% and every branch
# still learns
GAC_PARITY_RESIDUAL_SCALE = 0.1
# the card's own norm-wise error of each DCN or LookGround leaf against the
# f64 step: an H100 reads 3e-5 (LookGround) to 1e-4 (the head's DCN)
GAC_HEAD_LEAF_REL_CAP = 1e-3


def gac_train_parity_phase(torch, head):
    """One f32 training step (TF32 off) of ``build_gac_trainer`` at batch 2
    on the card against the same step on the CPU, same weights and batch
    (each bottleneck's last BatchNorm scale at GAC_PARITY_RESIDUAL_SCALE;
    running statistics set to the batch's; Yolo3D's offsets of std 0.5
    px; alpha and the prediction convs seeded, so that the gradient reaches
    the whole network), dropout off on both, at the KM3D step gates with
    another floor: both f32 steps are held against the same step on the
    CPU in f64, and the card's distance to it must stay within the CPU's
    own f32 distance times the gates' factors. Each loss term within
    max(8x the floor's difference, 2e-4 of its value); the gradients
    before the update clips them: the largest elementwise difference within
    8x the floor's (and 5e-2 of the largest gradient), the norm-wise
    difference over all parameters within 3x the floor's, each DCN or
    LookGround leaf within 4x the larger of its own floor and the
    all-parameter floor and within GAC_HEAD_LEAF_REL_CAP of the f64 step
    on its own (the floors of the DCN leaves are 0.6-0.9%, so the floor
    gate alone holds the step's wiring of K7 far looser than the kernel
    phase holds the kernel); the running statistics after the step within 1e-4
    of the CPU's; the parameters after the Adam step within 2.5 * lr of the
    CPU's.

    The KM3D phase's floor, the CPU's own step with the images moved by
    two f32 ulps, underestimates here: the BatchNorm backward after the
    head's DCN nearly cancels (the upstream gradient is mostly a
    per-channel constant, which it projects out), and there the CPU's f32
    gradients of the DCN leaves are 0.6-0.9% from the f64 step while the
    card's are 0.01% (measured on an H100); an input move does not show that
    rounding, the f64 step does."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import build_gac_system, build_gac_trainer
    from visualdet3d_tpu_torch.models.backbones.resnet import Bottleneck
    from visualdet3d_tpu_torch.testing import prepare_mono_for_training
    phase = f'{GAC_PHASE[head]}_train_parity'
    batch = train_batches_of(torch, testing.mono_training_batch, 1, PARITY_TRAIN_BATCH,
                             seed=48)[0]
    gpu, gpu_state, gpu_step = build_gac_trainer(device='cuda', batch_size=PARITY_TRAIN_BATCH,
                                                 head=head)
    with torch.no_grad():
        for m in gpu.net.modules():
            if isinstance(m, Bottleneck):
                m.BatchNorm_2.weight.mul_(GAC_PARITY_RESIDUAL_SCALE)
    prepare_mono_for_training(gpu, batch['images'], batch['P2'],
                              torch.Generator().manual_seed(49), offset_std=0.5)
    init = {k: v.cpu() for k, v in gpu.net.state_dict().items()}
    cpu, cpu_state, cpu_step = build_gac_trainer(device='cpu', batch_size=PARITY_TRAIN_BATCH,
                                                 head=head)
    cpu.net.load_state_dict(init)
    cpu.weights_changed()
    grads = {}
    for tag, sys_, state in (('gpu', gpu, gpu_state), ('cpu', cpu, cpu_state)):
        sys_.dropout = False
        update = state.optimizer.step

        def recording_update(tag=tag, sys_=sys_, update=update):
            grads[tag] = [(torch.zeros_like(p) if p.grad is None else p.grad).detach()
                          .double().cpu() for p in sys_.net.parameters()]
            update()
        state.optimizer.step = recording_update
    lr = cpu_state.optimizer.schedule(0)
    m_gpu = {k: float(v) for k, v in gpu_step(batch).items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    m_cpu = {k: float(v) for k, v in cpu_step(cpu_batch).items()}
    cpu_s = time.perf_counter() - t0
    # the reference: the same step's loss and gradients on the CPU in f64
    # (the loss itself in f32 on the f64 predictions, as in every step)
    ref = build_gac_system(device='cpu', head=head)
    ref.net.load_state_dict(init)
    ref.net.double()
    ref.dropout = False
    t0 = time.perf_counter()
    cls_loss, reg_loss, terms = ref.loss(
        cpu_batch['images'], cpu_batch['P2'], cpu_batch['annotations'],
        apply_fn=lambda net, images, P2: net(images.double(), P2=P2.double()))
    total = cls_loss.mean() + reg_loss.mean()
    total.backward()
    ref_s = time.perf_counter() - t0
    m_ref = {k: float(v.detach()) for k, v in terms.items()}
    m_ref['total'] = float(total.detach())
    g_ref = [(torch.zeros_like(p) if p.grad is None else p.grad).detach().double()
             for p in ref.net.parameters()]

    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-30) for k, v in m_ref.items()}
    loss_floor = {k: abs(m_cpu[k] - v) / max(abs(v), 1e-30) for k, v in m_ref.items()}
    g_gpu, g_cpu = grads['gpu'], grads['cpu']
    worst = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_ref))
    floor = max(float((a - b).abs().max()) for a, b in zip(g_cpu, g_ref))
    gmax = max(float(b.abs().max()) for b in g_ref)
    den = sum(float(b.norm()) ** 2 for b in g_ref)
    rel = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_gpu, g_ref)) / den) ** 0.5
    rel_floor = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_cpu, g_ref)) / den) ** 0.5
    rel_card_cpu = (sum(float((a - b).norm()) ** 2 for a, b in zip(g_gpu, g_cpu)) / den) ** 0.5
    names = [n for n, _ in cpu.net.named_parameters()]
    leaf = {n: (float((a - r).norm() / r.norm().clamp_min(1e-30)),
                float((c - r).norm() / r.norm().clamp_min(1e-30)), float(r.abs().max()))
            for a, c, r, n in zip(g_gpu, g_cpu, g_ref, names)}
    per_leaf = sorted(((e, n) for n, (e, _, _) in leaf.items()), reverse=True)
    # the leaves the aggregate gates cannot see: the DCN's weight and offset
    # conv, LookGround's disparity conv (learning through the grid, at 5%)
    # and alpha
    own = {n: v for n, v in leaf.items()
           if n.endswith(('ModulatedDeformConv_0.weight', 'ModulatedDeformConv_0.Conv_0.weight',
                          'LookGround_0.Conv_0.weight', 'LookGround_0.alpha'))}
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for pg, pc in zip(gpu.net.parameters(), cpu.net.parameters()))
    stats_err = max(float((bg.cpu() - bc).abs().max() / bc.abs().max().clamp_min(1e-30))
                    for bg, bc in zip(gpu.net.buffers(), cpu.net.buffers())
                    if bg.is_floating_point())
    emit(phase, batch=PARITY_TRAIN_BATCH, dtype='float32', tf32=False,
         reference='the CPU step in f64',
         loss_rel_err=loss_err, loss_rel_err_floor=loss_floor, grad_max_abs_err=worst,
         grad_max_abs_err_floor=floor, grad_max=gmax, grad_rel_err_all=rel,
         grad_rel_err_all_floor=rel_floor, grad_rel_diff_card_cpu=rel_card_cpu,
         grad_rel_err_worst_leaves=per_leaf[:4],
         grad_rel_err_median_leaf=statistics.median(e for e, _ in per_leaf),
         head_leaves_rel_err_floor_max=own, param_max_abs_err=param_err, lr=lr,
         running_stats_rel_err=stats_err, cpu_step_s=cpu_s, f64_step_s=ref_s,
         total=m_gpu['total'])
    bad = {k: (loss_err[k], loss_floor[k]) for k in m_ref
           if loss_err[k] > max(8 * loss_floor[k], 2e-4)}
    check(not bad, f'{phase}: loss terms differ beyond the floor {bad}')
    check(worst <= max(8 * floor, 1e-5 * gmax) and worst <= 5e-2 * gmax and rel <= 3 * rel_floor,
          f'{phase}: gradients differ: max abs {worst} (floor {floor}, gmax {gmax}), '
          f'norm-wise {rel} (floor {rel_floor})')
    bad = {n: e for n, e in own.items()
           if e[0] > min(4 * max(e[1], rel_floor), GAC_HEAD_LEAF_REL_CAP) or e[2] == 0}
    check(len(own) == 2 and not bad,
          f'{phase}: {len(own)} head leaves, these differ beyond their floor or beyond '
          f'{GAC_HEAD_LEAF_REL_CAP}, or have no gradient (error, floor, max): {bad}')
    check(param_err <= 2.5 * lr, f'{phase}: parameters after the step differ by {param_err} '
                                 f'(lr {lr})')
    check(stats_err <= 1e-4, f'{phase}: running statistics differ by {stats_err}')
    del gpu, cpu, ref
    torch.cuda.empty_cache()


def gac_phases(torch, dc, peaks):
    """The GAC slice: for each head, the predict at batch 16 in f32 and bf16
    with a profile, batch-1 parity with the CPU; K3/K5/K7 at the head DCN's
    shape; the training step in bf16 and f32 for each head; one f32 step of
    each head against the CPU. Returns the numbers the ``kernels`` line
    reads."""
    slices, trains = {}, {}
    for head in ('ground_aware', 'dcn'):
        system = build_gac(torch, head)
        slices[head] = {}
        for dtype_name in ('float32', 'bfloat16'):
            slices[head][dtype_name], images, P2 = gac_slice_phase(torch, dc, system, head,
                                                                   dtype_name)
            gac_profile_phase(torch, system, head, images, P2, dtype_name)
            del images
        gac_parity_phase(torch, system, head)
        del system
        torch.cuda.empty_cache()
    kernel = gac_head_dcn_kernel_phase(torch, dc, peaks)
    for head in ('ground_aware', 'dcn'):
        trains[head] = {name: gac_train_phase(torch, dc, cd, head)
                        for name, cd in (('bfloat16', 'bfloat16'), ('float32', None))}
        gac_train_parity_phase(torch, head)
    return slices, kernel, trains


# --------------------------------------------------------------------------
# training from a KITTI tree: image I/O, the precompute CLIs, the train CLI
# --------------------------------------------------------------------------

KITTI_HW = (375, 1242)    # the KITTI object benchmark's image size
KM3D_TREE_FRAMES = 32     # 2 KM3D steps at batch 16 (no right-image doubling)
STEREO_TREE_FRAMES = 8    # 2 Stereo3D steps at batch 4
VAL_FRAMES = 4
N_DECODE = 16             # images decoded serially and by 8 threads


def data_io_phase():
    """The port's PNG writer and reader (``data/image_io.py``): each filter
    type's round trip bit for bit at 375x1242 RGB and 16-bit gray (C
    unfilter); the decode ms an image by filter type; the plain numpy
    unfilter on an image whose rows cycle through the five filters (bit for
    bit to the C one; its time); N_DECODE images decoded serially and by 8
    threads (ctypes releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor
    from visualdet3d_tpu_torch.data import image_io
    rng = np.random.default_rng(31)
    images = {'rgb8': rng.integers(0, 256, (*KITTI_HW, 3), np.uint8),
              'gray16': rng.integers(0, 65536, KITTI_HW, np.uint16)}
    image_io.decode_png(image_io.encode_png(images['rgb8'][:8]))  # builds the C unfilter
    decode_ms = {}
    for kind, image in images.items():
        decode_ms[kind] = {}
        for ftype in image_io.FILTER_TYPES:
            data = image_io.encode_png(image, (ftype,))
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = image_io.decode_png(data)
                times.append((time.perf_counter() - t0) * 1e3)
            check(out.dtype == image.dtype and np.array_equal(out, image),
                  f'data_io: {kind} filter {ftype} does not round-trip')
            decode_ms[kind][ftype] = statistics.median(times)
    cycling = image_io.encode_png(images['rgb8'], image_io.FILTER_TYPES)
    t0 = time.perf_counter()
    plain = image_io.decode_png(cycling, plain=True)
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fast = image_io.decode_png(cycling)
    c_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(plain, images['rgb8']) and np.array_equal(fast, plain),
          'data_io: the plain and C unfilters differ on the cycling-filter image')
    t0 = time.perf_counter()
    for _ in range(N_DECODE):
        image_io.decode_png(cycling)
    serial_ms = (time.perf_counter() - t0) * 1e3 / N_DECODE
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        list(pool.map(image_io.decode_png, [cycling] * N_DECODE))
        threaded_ms = (time.perf_counter() - t0) * 1e3 / N_DECODE
    emit('data_io', image_hw=list(KITTI_HW), decode_ms_by_filter=decode_ms,
         all_paeth_rgb_decode_ms=decode_ms['rgb8'][4], cycling_rgb_decode_ms=c_ms,
         cycling_rgb_plain_decode_ms=plain_ms, serial_ms_per_image=serial_ms,
         eight_threads_ms_per_image=threaded_ms, png_bytes_cycling_rgb=len(cycling),
         host_cpus=os.cpu_count())


def smoke_config(work, base, name, data_root, split, max_epochs):
    """A config file that loads ``configs/<base>`` through the port's
    ``cfg_from_file`` and sets only the paths, ``max_epochs`` and the
    evaluation (off: the training phases time training alone;
    ``cli_train_eval`` turns it on)."""
    path = os.path.join(work, f'{name}.py')
    root = os.path.dirname(os.path.abspath(__file__))
    with open(path, 'w') as f:
        f.write(f"""import os
from visualdet3d_tpu_torch.config import cfg_from_file
cfg = cfg_from_file({os.path.join(root, 'configs', base)!r})
out = os.path.join({work!r}, {name!r})
cfg.path.data_path = {data_root!r}
cfg.path.project_path = out
cfg.path.log_path = os.path.join(out, 'log')
cfg.path.checkpoint_path = os.path.join(out, 'checkpoint')
cfg.path.preprocessed_path = os.path.join(out, 'output')
if 'preprocessed_path' in cfg.detector.head:
    cfg.detector.head.preprocessed_path = cfg.path.preprocessed_path
cfg.data.train_split_file, cfg.data.val_split_file = {split[0]!r}, {split[1]!r}
cfg.trainer.max_epochs = {max_epochs}
cfg.trainer.test_iter = 0
""")
    return path


def kitti_precompute_phase(work):
    """``testing.write_synthetic_kitti``: KM3D_TREE_FRAMES full-size frames
    (the port's PNG writer, the rows cycling through all five filters); the
    port's imdb precompute for ``configs/km3d.py`` (its training split:
    every frame) and ``configs/stereo3d.py`` (the first STEREO_TREE_FRAMES;
    with the anchor priors), then the disparity precompute for the stereo
    config. Checks the record counts, finite priors and the disparity
    PNGs' shapes; prints the seconds of each. Returns the config paths."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.cli import disparity_compute, imdb_precompute_3d
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.image_io import read_png
    os.environ['VD3D_WORKDIR'] = os.path.join(work, 'workdirs')  # the configs make dirs there
    seconds = {}
    t0 = time.perf_counter()
    root = testing.write_synthetic_kitti(os.path.join(work, 'kitti'), KM3D_TREE_FRAMES, seed=7)
    seconds['write_tree'] = time.perf_counter() - t0
    val = range(KM3D_TREE_FRAMES - VAL_FRAMES, KM3D_TREE_FRAMES)
    splits = {'km3d': testing.write_split_files(os.path.join(work, 'split_km3d'),
                                                range(KM3D_TREE_FRAMES), val),
              'stereo': testing.write_split_files(os.path.join(work, 'split_stereo'),
                                                  range(STEREO_TREE_FRAMES), val)}
    configs, records = {}, {}
    for name, base, frames in (('km3d', 'km3d.py', KM3D_TREE_FRAMES),
                               ('stereo', 'stereo3d.py', STEREO_TREE_FRAMES)):
        configs[name] = smoke_config(work, base, name, root, splits[name], 1)
        cfg = cfg_from_file(configs[name])
        t0 = time.perf_counter()
        imdb_precompute_3d.run(cfg)
        seconds[f'imdb_{name}'] = time.perf_counter() - t0
        for split, n in (('training', frames), ('validation', VAL_FRAMES)):
            with open(os.path.join(cfg.path.preprocessed_path, split, 'imdb.pkl'), 'rb') as f:
                got = len(pickle.load(f))
            check(got == n, f'kitti_precompute {name}: {got} {split} records, expected {n}')
            records[f'{name}_{split}'] = got
    cfg = cfg_from_file(configs['stereo'])
    priors = {}
    for t in cfg.obj_types:
        stats = {stat: np.load(os.path.join(cfg.path.preprocessed_path, 'training',
                                            f'anchor_{stat}_{t}.npy')) for stat in ('mean', 'std')}
        for stat, arr in stats.items():
            check(arr.shape == (16, 3, 6) and np.isfinite(arr).all(),
                  f'kitti_precompute: anchor_{stat}_{t} {arr.shape}, finite {np.isfinite(arr).all()}')
        priors[t] = int((stats['mean'][..., 0] > 0).sum())  # bins of ten samples or more
    t0 = time.perf_counter()
    disparity_compute.run(cfg)
    seconds['disparity_stereo'] = time.perf_counter() - t0
    disp_dir = os.path.join(cfg.path.preprocessed_path, 'training', 'disp')
    names = sorted(os.listdir(disp_dir))
    check(len(names) == 2 * STEREO_TREE_FRAMES, f'kitti_precompute: {len(names)} disparity maps')
    nonzero = []
    for n in names:
        disp = read_png(os.path.join(disp_dir, n))
        check(disp.dtype == np.uint16 and disp.shape == (288 // 4, 1280 // 4),
              f'kitti_precompute: disparity map {n} is {disp.dtype} {disp.shape}')
        nonzero.append(int((disp > 0).sum()))
    emit('kitti_precompute', frames=KM3D_TREE_FRAMES, image_hw=list(KITTI_HW), seconds=seconds,
         records=records, prior_bins_with_samples=priors,
         disparity_maps=len(names), disparity_nonzero_min=min(nonzero),
         disparity_nonzero_mean=float(np.mean(nonzero)))
    return configs


def run_train_cli(config, resume, log_path):
    """``python -m visualdet3d_tpu_torch.cli.train`` in a subprocess (the
    card by default); its output goes to ``log_path``. Returns the wall
    seconds and the output."""
    cmd = [sys.executable, '-m', 'visualdet3d_tpu_torch.cli.train', '--config', config]
    if resume:
        cmd.append('--resume')
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    with open(log_path, 'a') as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f'{" ".join(cmd[1:])} failed (rc {proc.returncode}):\n'
                                f'{proc.stderr[-3000:]}')
    return wall, proc.stdout


def cli_train_phase(torch, config, phase, per_step):
    """The train CLI on ``config`` (the config's batch and size): one epoch
    of 2 steps, then ``max_epochs=2`` with ``--resume``, which must go on at
    step 2. Gates: finite losses, ``per_step`` kernel launches a step in
    each epoch, 2 checkpoints, and the checkpoint of step 2 restored into a
    fresh system on the card bit for bit (``checkpoint.load_train_state``,
    as ``--resume`` does). Prints the loader's ms a batch (8 threads, no
    step) against the step's ms, the host-to-device copies' share of a
    step and the share of the epoch's wall the loop waited on the loader."""
    from visualdet3d_tpu_torch import checkpoint
    from visualdet3d_tpu_torch.cli import train as train_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.loader import build_dataloader
    from visualdet3d_tpu_torch.pipelines.train_state import TrainState
    from visualdet3d_tpu_torch.registry import DATASET_DICT
    from visualdet3d_tpu_torch.solver.optimizers import build_optimizer
    import visualdet3d_tpu_torch.data  # noqa: F401
    cfg = cfg_from_file(config)
    log = os.path.join(os.path.dirname(config), f'{phase}.log')
    walls = [run_train_cli(config, False, log)[0]]
    with open(config, 'a') as f:
        f.write('cfg.trainer.max_epochs = 2\n')
    wall, out = run_train_cli(config, True, log)
    walls.append(wall)
    check('resumed from step 2 (epoch 1)' in out, f'{phase}: --resume did not go on at step 2:\n'
                                                  f'{out[-2000:]}')
    with open(os.path.join(cfg.path.log_path, 'train_stats.jsonl')) as f:
        epochs = [json.loads(line) for line in f]
    check([(e['epoch'], e['steps'], e['global_step']) for e in epochs] == [(0, 2, 2), (1, 2, 4)],
          f'{phase}: epochs {[(e["epoch"], e["steps"], e["global_step"]) for e in epochs]}')
    for e in epochs:
        check(np.isfinite(e['loss']), f'{phase}: epoch {e["epoch"]} loss {e["loss"]}')
        got = {k: v / e['steps'] for k, v in e['launches'].items() if k in per_step}
        check(got == per_step, f'{phase}: epoch {e["epoch"]} launched {e["launches"]} in '
                               f'{e["steps"]} steps, expected {per_step} a step')
    manager = checkpoint.CheckpointManager(cfg.path.checkpoint_path)
    check(manager.all_steps() == [2, 4], f'{phase}: checkpoints {manager.all_steps()}')

    # --resume's restore, in this process on the card: bit for bit
    saved = manager.restore(2)
    system = train_cli.build_system(cfg, torch.device('cuda'))
    state = TrainState(build_optimizer(system.net.parameters(), cfg.optimizer, cfg.scheduler, 1))
    checkpoint.load_train_state(system.net, state, saved)
    restored = system.net.state_dict()
    check(all(torch.equal(restored[k].cpu(), v) for k, v in saved['model'].items()),
          f'{phase}: the restored network differs from checkpoint 2')
    check(state.step == 2 and state.optimizer.count == saved['scheduler']['count'],
          f'{phase}: restored step {state.step}, count {state.optimizer.count} '
          f'(saved {saved["scheduler"]["count"]})')
    opt = state.optimizer.torch_optimizer.state_dict()['state']
    check(all(torch.equal(opt[i][k].cpu(), v[k]) for i, v in saved['optimizer']['state'].items()
              for k in v), f'{phase}: the restored Adam state differs from checkpoint 2')
    del system, state, saved, restored, opt
    torch.cuda.empty_cache()

    # the loader alone (the config's threads), as the CLI builds it
    dataset = DATASET_DICT[cfg.data.train_dataset](cfg, 'training')
    loader = build_dataloader(dataset, num_workers=cfg.data.num_workers,
                              batch_size=cfg.data.batch_size, training=True,
                              collate_fn=lambda items: dataset.collate_fn(
                                  items, obj_types=cfg.obj_types))
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(2):
        next(it)
    loader_ms = (time.perf_counter() - t0) * 1e3 / 2
    it.close()
    warm_ms = [e['step_ms'][-1] for e in epochs]  # each process's second step
    result = dict(
        batch=cfg.data.batch_size, image_hw=list(cfg.data.rgb_shape[:2]),
        loader_threads=cfg.data.num_workers, loader_ms_per_batch=loader_ms,
        item_stage_ms=item_stage_ms(dataset), step_ms=[e['step_ms'] for e in epochs],
        second_step_ms=warm_ms, loader_over_second_step=loader_ms / min(warm_ms),
        losses=[e['loss'] for e in epochs],
        launches_per_step={k: v / epochs[-1]['steps'] for k, v in epochs[-1]['launches'].items()},
        copy_device_ms_per_step=[e['copy_device_ms'] / e['steps'] for e in epochs],
        copy_share_of_second_step=[e['copy_device_ms'] / e['steps'] / w
                                   for e, w in zip(epochs, warm_ms)],
        loader_wait_share_of_epoch=[e['loader_wait_s'] / e['wall_s'] for e in epochs],
        epoch_wall_s=[e['wall_s'] for e in epochs], setup_s=[e['setup_s'] for e in epochs],
        checkpoint_save_s=[e['checkpoint_save_s'] for e in epochs], process_wall_s=walls)
    emit(phase, **result)
    return result


def item_stage_ms(dataset):
    """The ms of each stage of one training item, serially: decoding its
    image(s), each transform of the train augmentation in turn, and the
    targets (KM3D, MonoFlex)."""
    import copy
    from visualdet3d_tpu_torch.data.augmentations import SAMPLE_KEYS
    from visualdet3d_tpu_torch.data.image_io import read_image
    record = dataset.imdb[0]
    stereo = 'Stereo' in type(dataset).__name__
    times = {}
    t0 = time.perf_counter()
    sample = dict.fromkeys(SAMPLE_KEYS)
    sample['left_image'] = read_image(record['image_2_path'])
    if stereo:
        sample['right_image'] = read_image(record['image_3_path'])
        sample['p3'] = record['calib']['P3'].copy()
    times['decode'] = (time.perf_counter() - t0) * 1e3
    sample['p2'] = record['calib']['P2'].copy()
    sample['labels'] = [copy.deepcopy(o) for o in record['label'] if o.type in dataset.obj_types]
    np.random.seed(0)
    for i, transform in enumerate(dataset.transform.transforms):
        t0 = time.perf_counter()
        sample = transform(sample)
        times[f'{i}_{type(transform).__name__}'] = (time.perf_counter() - t0) * 1e3
    if hasattr(dataset, 'builder'):
        t0 = time.perf_counter()
        dataset.builder.build_target(sample['left_image'].shape[:2], sample['p2'],
                                     sample['labels'])
        times['targets'] = (time.perf_counter() - t0) * 1e3
    times['total'] = sum(times.values())
    return times


def km3d_resnet_parity_phase(torch):
    """KM3D on the ``resnet`` core (depth 18, the rest as
    ``configs/km3d.py``) at batch 1, f32: the card against the CPU at the
    KM3D gates (``km3d_parity_phase``)."""
    from visualdet3d_tpu_torch.config import EasyDict
    from visualdet3d_tpu_torch.entry import KM3D_IMAGE_HW
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT
    from visualdet3d_tpu_torch.testing import calibrate_head_convs, km3d_detector_cfg
    import visualdet3d_tpu_torch.models  # noqa: F401

    def make(device):
        cfg = km3d_detector_cfg()
        cfg.backbone = EasyDict(name='resnet', depth=18)
        return DETECTOR_DICT['KM3D'](cfg, device=device)
    system = make('cuda')
    gen = torch.Generator().manual_seed(17)
    calibrate_head_convs(system, torch.randn((4, *KM3D_IMAGE_HW, 3), generator=gen).cuda(), gen)
    km3d_parity_phase(torch, system, 'km3d_resnet', make=make)
    del system
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# evaluation on a KITTI tree: the evaluators, the eval and quantize CLIs, the
# evaluation inside the train CLI
# ---------------------------------------------------------------------------

ORACLE_FRAMES = 160       # label files only: every difficulty has 41+ valid Cars
ORACLE_SPLIT_FRAMES = 3769  # the frames of KITTI's usual validation split (3DOP's)
EVAL_REPEATS = 10         # a timed evaluation lists the VAL_FRAMES frames 10 times: 40 frames


def timed_eval_config(config):
    """``config`` evaluated on its VAL_FRAMES validation frames listed
    EVAL_REPEATS times, as ``loader_study.py`` lists its training frames:
    a split file and a validation imdb of the repeated frames under
    ``<preprocessed_path>_timed`` (its ``training`` a link to the config's
    own, which the int8 calibration reads), so that one run times
    VAL_FRAMES * EVAL_REPEATS frames. Result file i holds frame i mod
    VAL_FRAMES. Returns the new config's path."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    cfg = cfg_from_file(config)
    src = cfg.path.preprocessed_path
    dst = src + '_timed'
    os.makedirs(os.path.join(dst, 'validation'), exist_ok=True)
    if not os.path.exists(os.path.join(dst, 'training')):
        os.symlink(os.path.join(src, 'training'), os.path.join(dst, 'training'))
    with open(os.path.join(src, 'validation', 'imdb.pkl'), 'rb') as f:
        imdb = pickle.load(f)
    check(len(imdb) == VAL_FRAMES, f'timed_eval_config: {len(imdb)} validation records')
    with open(os.path.join(dst, 'validation', 'imdb.pkl'), 'wb') as f:
        pickle.dump(list(imdb) * EVAL_REPEATS, f)
    with open(cfg.data.val_split_file) as f:
        ids = f.read().split()
    split = os.path.join(dst, 'val_repeated.txt')
    with open(split, 'w') as f:
        f.write('\n'.join(ids * EVAL_REPEATS) + '\n')
    path = f'{config[:-3]}_timed.py'
    with open(config) as f, open(path, 'w') as g:
        g.write(f.read() + f'cfg.path.preprocessed_path = {dst!r}\n'
                           f'cfg.data.val_split_file = {split!r}\n')
    return path


def dtype_config(config, dtype):
    """``config`` with ``detector.inference_dtype`` = ``dtype``; returns its path."""
    path = f'{config[:-3]}_{dtype}.py'
    with open(config) as f, open(path, 'w') as g:
        g.write(f.read() + f'cfg.detector.inference_dtype = {dtype!r}\n')
    return path


def spread(ms):
    """The median, 10th and 90th percentiles, least and most of ``ms``."""
    a = np.asarray(ms, np.float64)
    return dict(n=len(a), median=float(np.median(a)), p10=float(np.percentile(a, 10)),
                p90=float(np.percentile(a, 90)), min=float(a.min()), max=float(a.max()))


def ap_table(text):
    """The AP rows of a KITTI report: {'<class> AP@<overlaps> <metric>': [easy,
    moderate, hard]}; every value must parse and be finite."""
    table, head = {}, None
    for line in text.splitlines():
        if 'AP(Average Precision)@' in line:
            head = line.split(':')[0].replace(' AP(Average Precision)', ' AP')
        elif head and 'AP:' in line:
            metric, values = line.split('AP:')
            table[f'{head} {metric.strip()}'] = [float(v) for v in values.split(',')]
    check(table and all(len(v) == 3 and np.isfinite(v).all() for v in table.values()),
          f'the AP table did not parse or is not finite:\n{text[-2000:]}')
    return table


def kitti_eval_oracle_phase(work):
    """The KITTI object evaluator on ORACLE_FRAMES label files
    (``testing.write_synthetic_labels``): the labels written back as results
    (score 1) give Car AP 100 on bbox, BEV, 3D and AOS at every difficulty
    (each has 41+ valid Cars, which the 40-point AP needs); every box moved
    1 m in x and z gives 3D AP below bbox AP; the native matcher's tables
    equal the Python matcher's on the moved results. Then the labels of
    ORACLE_SPLIT_FRAMES frames, the size of KITTI's validation split,
    written back as results: AP 100 again. Prints the evaluator's seconds
    for each split (the report end to end, files included) and both
    matchers' seconds for their tables."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.evaluator.kitti_object import eval as kitti_eval
    from visualdet3d_tpu_torch.evaluator.kitti_object.evaluate import evaluate
    from visualdet3d_tpu_torch.evaluator.kitti_object.kitti_common import get_label_annos
    root = os.path.join(work, 'oracle')
    frames = range(ORACLE_FRAMES)
    label_dir = testing.write_synthetic_labels(os.path.join(root, 'label_2'), frames, seed=5)
    split = testing.write_split_files(os.path.join(root, 'split'), [], frames)[1]
    gts = get_label_annos(label_dir, list(frames))
    valid_cars = [kitti_eval._prepare_data(gts, gts, 0, d)[-1] for d in range(3)]
    check(min(valid_cars) >= 41, f'kitti_eval_oracle: valid Cars by difficulty {valid_cars}')

    def write_results(name, shift, label_dir=label_dir, frames=frames):
        out = os.path.join(root, name)
        os.makedirs(out, exist_ok=True)
        for i in frames:
            with open(os.path.join(label_dir, '%06d.txt' % i)) as f:
                rows = [line.split() for line in f if line.strip() and
                        not line.startswith('DontCare')]
            for r in rows:
                r[11] = f'{float(r[11]) + shift:.2f}'
                r[13] = f'{float(r[13]) + shift:.2f}'
            with open(os.path.join(out, '%06d.txt' % i), 'w') as f:
                f.write(''.join(' '.join(r) + ' 1.0\n' for r in rows))
        return out

    seconds, tables = {}, {}
    for name, shift in (('exact', 0.0), ('moved', 1.0)):
        result_dir = write_results(name, shift)
        t0 = time.perf_counter()
        [report] = evaluate(label_dir, result_dir, split, current_classes=[0])
        seconds[f'evaluator_{name}'] = time.perf_counter() - t0
        tables[name] = ap_table(report)
    exact = tables['exact']
    check(all(v == [100.0, 100.0, 100.0] for v in exact.values()),
          f'kitti_eval_oracle: the ground truth as results gives {exact}')
    moved = tables['moved']
    for overlaps in ('0.70, 0.70, 0.70', '0.70, 0.50, 0.50'):
        bbox, d3 = moved[f'Car AP@{overlaps} bbox'], moved[f'Car AP@{overlaps} 3d']
        check(bbox == [100.0] * 3 and all(a < b for a, b in zip(d3, bbox)),
              f'kitti_eval_oracle: boxes moved 1 m give bbox {bbox}, 3d {d3}')

    dts = get_label_annos(os.path.join(root, 'moved'))
    overlaps = np.stack([np.array([[0.7]] * 3), np.array([[0.7], [0.5], [0.5]])])
    same = {}
    for metric in (0, 1, 2):
        got = {}
        for matcher in ('native', 'python'):
            t0 = time.perf_counter()
            got[matcher] = kitti_eval.eval_class(gts, dts, [0], (0, 1, 2), metric, overlaps,
                                                 compute_aos=True, matcher=matcher)
            seconds[f'{matcher}_metric{metric}'] = time.perf_counter() - t0
        same[metric] = all(np.array_equal(got['native'][k], got['python'][k])
                           for k in ('precision', 'orientation'))
    check(all(same.values()), f'kitti_eval_oracle: native and Python matchers differ {same}')

    full = range(ORACLE_SPLIT_FRAMES)
    full_labels = testing.write_synthetic_labels(os.path.join(root, 'full_label_2'), full, seed=6)
    full_split = testing.write_split_files(os.path.join(root, 'full_split'), [], full)[1]
    result_dir = write_results('full_exact', 0.0, full_labels, full)
    t0 = time.perf_counter()
    [report] = evaluate(full_labels, result_dir, full_split, current_classes=[0])
    seconds['evaluator_full_split'] = time.perf_counter() - t0
    full_exact = ap_table(report)
    check(all(v == [100.0, 100.0, 100.0] for v in full_exact.values()),
          f'kitti_eval_oracle: {ORACLE_SPLIT_FRAMES} frames of ground truth give {full_exact}')
    emit('kitti_eval_oracle', frames=ORACLE_FRAMES, valid_cars_by_difficulty=valid_cars,
         exact=exact, moved_1m=moved, matchers_equal=same,
         full_split_frames=ORACLE_SPLIT_FRAMES, full_split_exact=full_exact, seconds=seconds)


def eval_ready_checkpoint(torch, config, name, prepare):
    """The train CLI's latest checkpoint of ``config`` loaded into the
    config's inference system on the card, ``prepare(system, batch)`` on the
    validation frames (seeded weights that barely trained give no score
    above the thresholds), saved as a checkpoint of its own; returns its
    directory."""
    from visualdet3d_tpu_torch import checkpoint
    from visualdet3d_tpu_torch.cli import eval as eval_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    cfg = cfg_from_file(config)
    cfg.detector.inference_dtype = 'float32'
    system = eval_cli.load_system(cfg, cfg.path.checkpoint_path, torch.device('cuda'))
    val = eval_cli.dataset_of(cfg, 'validation')
    prepare(system, val.collate_fn([val[i] for i in range(len(val))]))
    out = os.path.join(os.path.dirname(config), f'{name}_eval_checkpoint')
    checkpoint.CheckpointManager(out).save(0, {'model': system.net.state_dict()})
    del system
    torch.cuda.empty_cache()
    return out


def run_eval_cli(torch, config, ckpt, phase, device=None, quantized_path=None,
                 frames=VAL_FRAMES * EVAL_REPEATS):
    """``cli.eval.main`` in this process on the validation split (the card
    unless ``device``), the launch counts set to 0 just before: (its
    eval_stats line, its output, the result files' text, the counts). The
    split must hold ``frames`` frames (a config of ``timed_eval_config``,
    else VAL_FRAMES)."""
    import contextlib
    import io
    from visualdet3d_tpu_torch.cli import eval as eval_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = cfg_from_file(config)
    argv = ['--config', config, '--checkpoint_path', ckpt]
    argv += ['--device', device] if device else []
    argv += ['--quantized_path', quantized_path] if quantized_path else []
    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_cli.main(argv)
    launches = launch_counts()
    out = buf.getvalue()
    with open(os.path.join(cfg.path.log_path, 'eval_stats.jsonl')) as f:
        stats = json.loads(f.readlines()[-1])
    result_dir = os.path.join(cfg.path.preprocessed_path, 'validation', 'data')
    files = {}
    for n in sorted(os.listdir(result_dir)):
        with open(os.path.join(result_dir, n)) as f:
            files[n] = f.read()
    check(len(files) == stats['frames'] == frames,
          f'{phase}: {len(files)} result files for {stats["frames"]} frames, expected {frames}')
    return stats, out, files, launches


def eval_summary(stats, files, table, launches):
    """A run's frames, the ms of a frame on the card (predict, decode, NMS,
    the copy to the host) and of its item on the host, each after the
    first frame (cuDNN's first calls at batch 1), the first frame's,
    the evaluator's and the set-up's seconds, the detections, the launches
    a frame and the moderate Car APs."""
    frames = stats['frames']
    return dict(
        frames=frames, frame_ms=spread(stats['frame_ms'][1:]),
        first_frame_ms=stats['frame_ms'][0], item_ms=spread(stats['load_ms'][1:]),
        evaluator_s=stats['evaluator_s'],
        setup_s=stats['setup_s'], detections=sum(t.count('\n') for t in files.values()),
        frames_with_detections=sum(bool(t) for t in files.values()),
        launches_per_frame={k: v / frames for k, v in launches.items() if v},
        car_ap_moderate={k: v[1] for k, v in table.items() if k.startswith('Car')})


def cli_eval_phase(torch, config, ckpt, phase, dtype, per_frame):
    """The eval CLI on the card on ``config`` with ``inference_dtype`` =
    ``dtype``: a txt a frame, a frame with detections, the AP table parsed
    and finite, ``per_frame`` kernel launches a frame over the frames (the
    CLI's count around the evaluation; the whole run's, set to 0 just
    before it, also holds the bf16 fold's forward). Returns (the summary,
    the result files)."""
    stats, out, files, launches = run_eval_cli(torch, dtype_config(config, dtype), ckpt, phase)
    check(any(files.values()), f'{phase}: no detection in any frame')
    table = ap_table(out)
    got = {k: stats['launches'].get(k, 0) / stats['frames'] for k in per_frame}
    check(got == per_frame, f'{phase}: launches a frame {got}, expected {per_frame}')
    check(all(launches[k] >= v for k, v in stats['launches'].items()),
          f'{phase}: the CLI counted {stats["launches"]}, the whole run {launches}')
    result = dict(dtype=dtype, **eval_summary(stats, files, table, stats['launches']),
                  launches_in_cli_run={k: v for k, v in launches.items() if v})
    emit(phase, **result)
    return result, files


def result_rows(text):
    rows = [line.split() for line in text.splitlines()]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows]).reshape(-1, 15)


def cli_eval_parity_phase(torch, runs):
    """The result files of the card (f32, TF32 off; the first VAL_FRAMES
    of its timed run) against the eval CLI with ``--device cpu`` on the
    same checkpoints and frames: the same lines and
    labels, numbers within the predict parity gates (rtol = atol = 1e-3;
    KM3D's location, and the yaw computed from it, within rtol 1e-2, as
    ``km3d_parity`` holds the centre). Lines are matched one to one in any
    order: two detections whose scores lie within the devices' difference
    (5e-7 apart in one Stereo3D frame on an H100) may come in either order."""
    out = {}
    for name, (config, ckpt, card_files) in runs.items():
        t0 = time.perf_counter()
        _, _, cpu_files, _ = run_eval_cli(torch, config, ckpt, f'cli_eval_parity {name}',
                                          device='cpu', frames=VAL_FRAMES)
        cpu_s = time.perf_counter() - t0
        loose = np.zeros(15, bool)  # KM3D's centre and the yaw computed from it
        loose[[10, 11, 12, 13]] = name == 'km3d'

        def close(a, b):
            return (np.isclose(a[~loose], b[~loose], rtol=1e-3, atol=1e-3).all()
                    and np.isclose(a[loose], b[loose], rtol=1e-2, atol=1e-3).all())
        errs, lines, reordered = [], 0, 0
        for n, text in card_files.items():
            names, vals = result_rows(text)
            cpu_names, cpu_vals = result_rows(cpu_files[n])
            check(len(names) == len(cpu_names),
                  f'cli_eval_parity {name} {n}: {len(names)} lines on the card, '
                  f'{len(cpu_names)} on the CPU')
            unused = list(range(len(cpu_names)))
            for i in range(len(names)):
                hit = next((j for j in unused if cpu_names[j] == names[i]
                            and close(vals[i], cpu_vals[j])), None)
                check(hit is not None, f'cli_eval_parity {name} {n}: the card\'s line {i} has '
                                       f'no match on the CPU:\n{text}CPU\n{cpu_files[n]}')
                unused.remove(hit)
                reordered += hit != i
                errs.append(float(np.abs(vals[i] - cpu_vals[hit]).max()))
            lines += len(names)
        check(lines > 0, f'cli_eval_parity {name}: no result line to compare')
        out[name] = dict(lines=lines, lines_in_another_order=reordered, max_abs_diff=max(errs),
                         cpu_eval_s=cpu_s)
    emit('cli_eval_parity', **out)


def cli_eval_gac_postopt_phase(torch, work, root, split):
    """``configs/yolo3d_gac.py`` (``post_optimization=True``) on the tree:
    the imdb precompute, synthetic priors in place of the 8-frame ones
    (bins with fewer than 10 samples drop their anchors), the port's GAC
    with seeded weights made ready to predict on the validation frames
    (``testing.prepare_mono_for_predict``, then the class bias shifted so
    that the top 0.5% of the anchors the decode keeps score above
    sigmoid(1.5): ResNet-101's logits put the calibrated tail elsewhere)
    saved by ``checkpoint.py``, then the eval CLI. At least one detection must be refined by the hill climb
    (its alpha moved). The eval runs on the repeated frames of
    ``timed_eval_config``; prints the post-optimisation's ms a frame."""
    from visualdet3d_tpu_torch import checkpoint, testing
    from visualdet3d_tpu_torch.cli import eval as eval_cli
    from visualdet3d_tpu_torch.cli import imdb_precompute_3d
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.models.fast_utils import hill_climbing
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT
    import visualdet3d_tpu_torch.models  # noqa: F401
    config = smoke_config(work, 'yolo3d_gac.py', 'gac', root, split, 1)
    cfg = cfg_from_file(config)
    check(cfg.detector.head.test_cfg.post_optimization, 'the GAC config does not post-optimise')
    imdb_precompute_3d.run(cfg)
    testing.write_synthetic_priors(cfg.path.preprocessed_path, cfg.obj_types, num_ratios=2)
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device='cuda')
    val = eval_cli.dataset_of(cfg, 'validation')
    batch = val.collate_fn([val[i] for i in range(len(val))])
    images = torch.as_tensor(batch['images'], device='cuda')
    P2 = torch.as_tensor(batch['P2'], device='cuda')
    testing.prepare_mono_for_predict(system, images, P2, torch.Generator().manual_seed(42))
    with torch.no_grad():  # the logits' tail onto the anchors the decode keeps
        cls = system.predict_raw(images, P2)[0][..., 0].float()
        useful = system.anchors.useful_mask(system.anchor_pack(tuple(images.shape[1:3])), P2)
        system.prediction_convs()[0].bias += 1.5 - torch.quantile(cls[useful], 0.995)
    system.weights_changed()
    ckpt = os.path.join(work, 'gac_checkpoint')
    checkpoint.CheckpointManager(ckpt).save(0, {'model': system.net.state_dict()})
    del system, images, P2
    torch.cuda.empty_cache()

    refined = []
    real = hill_climbing.post_optimization

    def counting(bbox_2d, state, P2, names, **kw):
        out = real(bbox_2d, state, P2, names, **kw)
        refined.append(int((out[:, 6] != np.asarray(state)[:, 6]).sum()))
        return out
    hill_climbing.post_optimization = counting
    try:
        stats, out, files, launches = run_eval_cli(torch, timed_eval_config(config), ckpt,
                                                   'cli_eval_gac_postopt')
    finally:
        hill_climbing.post_optimization = real
    check(any(files.values()), 'cli_eval_gac_postopt: no detection in any frame')
    check(sum(refined) >= 1, f'cli_eval_gac_postopt: the hill climb refined {refined} detections')
    emit('cli_eval_gac_postopt', refined=sum(refined), refined_per_frame=spread(refined),
         post_opt_ms=spread(stats['post_opt_ms'][1:]),
         **eval_summary(stats, files, ap_table(out), stats['launches']))


def cli_quantize_eval_int8_phase(torch, work, stereo_config, ckpt):
    """``configs/stereo3d_int8.py`` on the stereo tree: ``python -m
    visualdet3d_tpu_torch.cli.quantize`` (a subprocess) writes the int8
    artifact of the stereo checkpoint; then the eval CLI with
    ``--quantized_path`` and the eval CLI calibrating on the fly (training
    frames): their result files equal byte for byte, with detections; B8,
    the quantize and 2 K1 launches a frame."""
    config = os.path.join(work, 'stereo_int8.py')
    with open(stereo_config) as f, open(config, 'w') as g:
        g.write(f.read().replace(os.path.join('configs', 'stereo3d.py'),
                                 os.path.join('configs', 'stereo3d_int8.py')))
    artifact = os.path.join(work, 'stereo_int8.pt')
    cmd = [sys.executable, '-m', 'visualdet3d_tpu_torch.cli.quantize', '--config', config,
           '--checkpoint_path', ckpt, '--output_path', artifact]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    quantize_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'cli.quantize failed (rc {proc.returncode}):\n'
                                f'{proc.stderr[-3000:]}')
    runs = {}
    for name, path in (('artifact', artifact), ('on_the_fly', None)):
        t0 = time.perf_counter()
        stats, out, files, launches = run_eval_cli(torch, config, ckpt,
                                                   f'cli_quantize_eval_int8 {name}',
                                                   quantized_path=path)
        runs[name] = dict(process_s=time.perf_counter() - t0, files=files,
                          **eval_summary(stats, files, ap_table(out), stats['launches']),
                          launches_in_cli_run={k: v for k, v in launches.items() if v})
    check(runs['artifact']['files'] == runs['on_the_fly']['files'],
          'cli_quantize_eval_int8: the artifact and the on-the-fly calibration wrote different '
          'results')
    check(any(runs['artifact']['files'].values()), 'cli_quantize_eval_int8: no detection')
    for name, r in runs.items():
        per = r['launches_per_frame']
        check(per.get('correlation_volume_interleaved') == 2 and per.get('int8_conv2d', 0) > 0
              and per.get('int8_quantize', 0) > 0,
              f'cli_quantize_eval_int8 {name}: launches a frame {per}')
        del r['files']
    emit('cli_quantize_eval_int8', quantize_process_s=quantize_s, results_equal=True, **runs)
    return runs


def cli_train_eval_phase(torch, km3d_config):
    """The train CLI (in this process) on the KM3D smoke config with
    ``test_iter=1``: one epoch of 2 steps at batch 16, then the evaluation
    of the validation split, which must print the AP table and write its
    stats line (16 DCN launches a frame, the training weights in f32)."""
    import contextlib
    import io
    from visualdet3d_tpu_torch.cli import train as train_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    config = km3d_config[:-3] + '_train_eval.py'
    with open(km3d_config) as f, open(config, 'w') as g:
        g.write(f.read() + "cfg.path.checkpoint_path = os.path.join(out, 'train_eval_ckpt')\n"
                           "cfg.path.log_path = os.path.join(out, 'train_eval_log')\n"
                           'cfg.trainer.max_epochs = 1\ncfg.trainer.test_iter = 1\n')
    cfg = cfg_from_file(config)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(['--config', config])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    check('/**** finish testing after training epoch 0 ******/' in out,
          f'cli_train_eval: no evaluation after the epoch:\n{out[-2000:]}')
    table = ap_table(out)
    with open(os.path.join(cfg.path.log_path, 'eval_stats.jsonl')) as f:
        [stats] = [json.loads(line) for line in f]
    per_frame = stats['launches'].get('modulated_deform_conv', 0) / stats['frames']
    check(stats['epoch'] == 0 and per_frame == DCN_PER_FORWARD,
          f'cli_train_eval: stats {stats}')
    emit('cli_train_eval', wall_s=wall, frames=stats['frames'],
         frame_ms=spread(stats['frame_ms']), evaluator_s=stats['evaluator_s'],
         dcn_launches_per_frame=per_frame, car_ap_moderate={k: v[1] for k, v in table.items()})


def kitti_eval_phases(torch, work, configs):
    """Evaluation on the KITTI tree, after the train CLI phases: the
    oracle, the eval CLI on KM3D and Stereo3D (f32, then bf16), GAC with
    post-optimisation, the int8 artifact against calibrating on the fly
    (each on VAL_FRAMES * EVAL_REPEATS frames: ``timed_eval_config``), the
    card's results against the CPU's (VAL_FRAMES frames), and the train
    CLI's evaluation (VAL_FRAMES frames).
    Returns the launches a frame by kernel and dtype."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.config import cfg_from_file
    t0 = time.perf_counter()
    kitti_eval_oracle_phase(work)

    def km3d_prepare(system, batch):
        images = torch.as_tensor(batch['images'], device='cuda')
        testing.calibrate_head_convs(system, images, torch.Generator().manual_seed(43))

    def stereo_prepare(system, batch):
        inputs = tuple(torch.as_tensor(batch[k], device='cuda')
                       for k in ('left_images', 'right_images'))
        testing.calibrate_prediction_convs(system, inputs, torch.Generator().manual_seed(44))

    stereo_cfg = cfg_from_file(configs['stereo'])
    stereo_split = (stereo_cfg.data.train_split_file, stereo_cfg.data.val_split_file)
    # the 8-frame priors leave every bin under 10 samples, which drops its anchors
    testing.write_synthetic_priors(stereo_cfg.path.preprocessed_path, stereo_cfg.obj_types,
                                   num_ratios=3)
    ckpts = {'km3d': eval_ready_checkpoint(torch, configs['km3d'], 'km3d', km3d_prepare),
             'stereo': eval_ready_checkpoint(torch, configs['stereo'], 'stereo', stereo_prepare)}
    per_frame = {'km3d': {'modulated_deform_conv': DCN_PER_FORWARD},
                 'stereo': {'correlation_volume_interleaved': 2}}
    timed = {name: timed_eval_config(configs[name]) for name in ('km3d', 'stereo')}
    launches, f32_files = {}, {}
    for name in ('km3d', 'stereo'):
        for dtype in ('float32', 'bfloat16'):
            result, files = cli_eval_phase(torch, timed[name], ckpts[name], f'cli_eval_{name}',
                                           dtype, per_frame[name])
            launches[(name, dtype)] = result['launches_per_frame']
            if dtype == 'float32':
                first = {n: files[n] for n in sorted(files)[:VAL_FRAMES]}
                f32_files[name] = (dtype_config(configs[name], dtype), ckpts[name], first)
    cli_eval_gac_postopt_phase(torch, work, stereo_cfg.path.data_path, stereo_split)
    int8 = cli_quantize_eval_int8_phase(torch, work, timed['stereo'], ckpts['stereo'])
    launches[('stereo', 'int8')] = int8['artifact']['launches_per_frame']
    cli_eval_parity_phase(torch, f32_files)
    cli_train_eval_phase(torch, configs['km3d'])
    emit('kitti_eval_phases', seconds=time.perf_counter() - t0)
    return launches


def kitti_training_phases(torch):
    """Training and evaluation from a KITTI tree on disk: data_io,
    kitti_precompute, cli_train_km3d, cli_train_stereo, then the evaluation
    phases (``kitti_eval_phases``), the A6 phases on the trees, the int8
    mono and process-group phases (``int8_mono_ddp_tree_phases``),
    km3d_resnet_parity. Returns the CLI
    training phases' results and the launches a frame of the evaluations."""
    import tempfile
    data_io_phase()
    with tempfile.TemporaryDirectory(prefix='vd3d_smoke_') as work:
        configs = kitti_precompute_phase(work)
        dcn = {'modulated_deform_conv': DCN_PER_FORWARD,
               'modulated_deform_conv_backward_input': DCN_PER_FORWARD,
               'modulated_deform_conv_backward_weight': DCN_PER_FORWARD}
        km3d = cli_train_phase(torch, configs['km3d'], 'cli_train_km3d', dcn)
        corr = {'correlation_volume_interleaved': 2, 'correlation_backward_interleaved': 2}
        stereo = cli_train_phase(torch, configs['stereo'], 'cli_train_stereo', corr)
        eval_launches = kitti_eval_phases(torch, work, configs)
        a6_cli = a6_tree_phases(torch, work, configs['km3d'])
        mono_int8_cli = int8_mono_ddp_tree_phases(torch, work, configs)
    km3d_resnet_parity_phase(torch)
    return km3d, stereo, eval_launches, a6_cli, mono_int8_cli


def a6_tree_phases(torch, work, km3d_config):
    """The A6 slice from trees on disk: depth_data (the synthetic depth
    tree, the datasets, the prior precompute), cli_train_monodepth,
    cli_eval_monodepth, and cli_train_retinanet on the KITTI object tree of
    ``km3d_config``. Returns the launches a step and a frame they counted."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    t0 = time.perf_counter()
    _, config = depth_data_phase(work)
    train = cli_train_monodepth_phase(torch, config)
    evaluation = cli_eval_monodepth_phase(torch, config)
    root = cfg_from_file(km3d_config).path.data_path
    cli_train_retinanet_phase(torch, work, root,
                              range(KM3D_TREE_FRAMES - VAL_FRAMES, KM3D_TREE_FRAMES))
    emit('a6_tree_phases', seconds=time.perf_counter() - t0)
    return dict(launches_per_step=train['launches_per_step'],
                eval_launches_per_frame=evaluation['launches_per_frame'])


# ---------------------------------------------------------------------------
# RetinaNet 2D and MonoDepth (slice A6): inference, training, the depth data
# path, the CLIs, and K3/K5/K7 (K4/K6) at the U-Net's three DCN shapes
# ---------------------------------------------------------------------------

A6_TRAIN_BATCH = 8       # both configs' training batch
MONODEPTH_BATCH = 8      # configs/monodepth.py's batch: MonoDepth's predict batch too
# the U-Net's DCNs at 352x1216: (name, H, W, C_in, C_out)
MONODEPTH_DCNS = (('up0', 22, 76, 768, 256), ('up1', 44, 152, 384, 64),
                  ('up2', 88, 304, 64, 64))
MONODEPTH_DCN_PER_FORWARD = len(MONODEPTH_DCNS)
DEPTH_TREE_FRAMES = 16   # 2 MonoDepth steps at batch 8
RETINA_TREE_FRAMES = 16  # 2 RetinaNet steps at batch 8, from the KM3D tree's frames
A6_RESIDUAL_SCALE = 0.1  # the residual branches' last BN scale in the step parities
# the learning rate of RetinaNet's loss-fall check: at the config's SGD lr 0.01 a
# random-weight RetinaNet swings over 10 steps on one batch (90 to 3720 on the CPU at
# 192x640; 43 to 18737 in f32 on the card), at 1e-3 it falls (90 to 22)
RETINANET_FALL_LR = 1e-3
# MonoDepth's DCN and LookGround leaves in the step parity, each on its own
# against the f64 step: the CPU's own f32 step sits 0.04-0.26% from it there
# (not GAC's 0.6-0.9%), and the card within 2.5x of that (on an H100), so
# the floor gate holds them; the cap only bounds a gross error
MONODEPTH_LEAF_REL_CAP = 1e-2


def a6_inputs(torch, n, batch, image_hw, seed):
    """n distinct request batches of standard-normal images on the card and
    the KITTI P2 scaled to the width, tiled to the batch."""
    from visualdet3d_tpu_torch.testing import _kitti_P2
    gen = torch.Generator(device='cuda').manual_seed(seed)
    images = [torch.randn((batch, *image_hw, 3), generator=gen, device='cuda') for _ in range(n)]
    P2 = torch.as_tensor(np.tile(_kitti_P2(image_hw[1]), (batch, 1, 1)), device='cuda')
    return images, P2


def build_retinanet(torch):
    """``entry.build_retinanet_system`` on the card, random weights from
    seed 0, made ready on 4 images (``testing.prepare_retinanet``: batch
    statistics, the prediction convs calibrated: zero as initialised,
    every score sits at the prior 0.01)."""
    from visualdet3d_tpu_torch.entry import RETINANET_IMAGE_HW, build_retinanet_system
    from visualdet3d_tpu_torch.testing import prepare_retinanet
    system = build_retinanet_system(device='cuda')
    (calib,), _ = a6_inputs(torch, 1, 4, RETINANET_IMAGE_HW, seed=61)
    prepare_retinanet(system, calib, torch.Generator().manual_seed(62))
    return system


def build_monodepth(torch):
    """``entry.build_monodepth_system`` on the card, random weights from
    seed 0, made ready on 4 images (``testing.prepare_monodepth``: batch
    statistics, the DCNs' offsets at std 2 px, ``LookGround`` alpha 0.5)."""
    from visualdet3d_tpu_torch.entry import MONODEPTH_IMAGE_HW, build_monodepth_system
    from visualdet3d_tpu_torch.testing import prepare_monodepth
    system = build_monodepth_system(device='cuda')
    (calib,), P2 = a6_inputs(torch, 1, 4, MONODEPTH_IMAGE_HW, seed=63)
    prepare_monodepth(system, calib, P2, torch.Generator().manual_seed(64))
    return system


def bs1_latencies(torch, fn, inputs):
    """Host ms of ``fn(x)`` one at a time, synchronised, over N_BS1 calls
    cycling through ``inputs`` after one warm-up call."""
    fn(inputs[0])
    lats = []
    for i in range(N_BS1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t) * 1e3)
    return lats


def retinanet_slice_phase(torch, system, dtype_name):
    """``RetinaNet.predict`` at batch 16, 384x1280, over N_BATCHES distinct
    request batches: ms per batch, fps, batch-1 p50, peak memory, valid
    detections (the decode and NMS on the card); outputs [B, 64] finite."""
    from visualdet3d_tpu_torch.entry import RETINANET_IMAGE_HW
    system.cfg.inference_dtype = dtype_name
    batches, _ = a6_inputs(torch, N_BATCHES + 1, BATCH, RETINANET_IMAGE_HW, seed=65)
    system.predict(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = [system.predict(images) for images in batches[1:]]
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 64, 4) and o['scores'].shape == (BATCH, 64),
              f'retinanet_slice {dtype_name}: output shapes {o["bboxes"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()), f'retinanet_slice {dtype_name}: {key}')
    check(min(n_valid) > 0, f'retinanet_slice {dtype_name}: a batch with no detection {n_valid}')
    lats = bs1_latencies(torch, system.predict, [b[:1].clone() for b in batches])
    result = dict(dtype=dtype_name, batch=BATCH, image_hw=list(RETINANET_IMAGE_HW),
                  anchors=int(system.anchor_pack(RETINANET_IMAGE_HW).shape[0]),
                  ms_per_batch=ms_batch, fps=BATCH / ms_batch * 1e3,
                  bs1_p50_ms=statistics.median(lats), bs1_ms=lats, valid_per_batch=n_valid,
                  peak_memory_gb=peak_gb)
    emit('retinanet_slice', **result)
    return result, batches[1]


def retinanet_profile_phase(torch, system, images, dtype_name):
    """A profiler breakdown of one batch-16 predict, and by CUDA events the
    network alone against the whole predict (decode and NMS the rest)."""
    system.cfg.inference_dtype = dtype_name
    system.predict(images)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(images))
    net = system.inference_net()
    x = system._images(images, system.inference_dtype())
    runs = range(5)
    with torch.inference_mode():
        net_ms = cuda_ms(lambda _: net(x), runs, warmup=1)
    predict_ms = cuda_ms(lambda _: system.predict(images), runs, warmup=1)
    emit('retinanet_profile', dtype=dtype_name, batch=BATCH, wall_ms=wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms,
         events_predict_ms=predict_ms, events_network_ms=net_ms,
         decode_nms_share_of_predict=1 - net_ms / predict_ms, top_ops=top_events(ops, 12),
         top_kernels=top_events(kernels, 12))


def retinanet_parity_phase(torch, system):
    """Batch 1, f32, TF32 off: the card's RetinaNet against the same weights
    on the CPU: the same number of detections, matched one to one in any
    order (the same label, scores within 1e-3, boxes within rtol = atol =
    1e-3; cuDNN and oneDNN move the logits by up to 3e-4, the scores by
    5e-5), raw maps within 1e-3 of their largest value.

    The class bias is first moved so that the score threshold falls in the
    widest gap between the image's 30th to 60th largest class logits: with
    the calibrated head some 6000 logits of the 276,210 pass it, their
    scores crowd together, and greedy NMS then keeps another of two
    overlapping boxes whose scores the two devices order differently (a
    Pedestrian at 0.9347 had no match on the CPU, on an H100)."""
    from visualdet3d_tpu_torch.entry import RETINANET_IMAGE_HW, build_retinanet_system
    system.cfg.inference_dtype = 'float32'
    rng = np.random.default_rng(66)
    image = torch.from_numpy(rng.standard_normal((1, *RETINANET_IMAGE_HW, 3)).astype(np.float32))
    with torch.no_grad():
        top = system.predict_raw(image)[0].float().flatten().topk(61).values.cpu()
        k = 30 + int((top[29:60] - top[30:61]).argmax())  # the threshold between top[k-1] and top[k]
        system.net.retina_cls.bias -= float(top[k - 1] + top[k]) / 2
    system.weights_changed()
    cpu = build_retinanet_system(device='cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    out_gpu = {k: v.cpu() for k, v in system.predict(image).items()}
    raw_gpu = [t.float().cpu() for t in system.predict_raw(image)]
    out_cpu = cpu.predict(image)
    raw_cpu = [t.float() for t in cpu.predict_raw(image)]
    raw_err = [float((g - c).abs().max() / c.abs().max()) for g, c in zip(raw_gpu, raw_cpu)]
    check(max(raw_err) <= 1e-3, f'retinanet_parity: raw maps differ {raw_err}')
    valid = out_cpu['valid']
    check(int(valid.sum()) > 0, 'retinanet_parity: no valid detection at batch 1')
    check(torch.equal(out_gpu['valid'], valid),
          f'retinanet_parity: valid sets differ: gpu {out_gpu["valid"].nonzero().tolist()} '
          f'cpu {valid.nonzero().tolist()}')
    # the detections as a set: NMS keeps them in score order, and two scores
    # a few ulps apart may come in the other order on the other device
    rows = {}
    for tag, out in (('gpu', out_gpu), ('cpu', out_cpu)):
        v = out['valid'][0]
        rows[tag] = (out['labels'][0][v].tolist(), out['bboxes'][0][v].double(),
                     out['scores'][0][v].double())
    used, box_err, score_err, swapped = set(), 0.0, 0.0, 0
    for i, (label, box, score) in enumerate(zip(*rows['gpu'])):
        found = None
        for j, (label_c, box_c, score_c) in enumerate(zip(*rows['cpu'])):
            if (j not in used and label_c == label and abs(float(score - score_c)) <= 1e-3
                    and bool(torch.allclose(box, box_c, rtol=1e-3, atol=1e-3))):
                found = j
                break
        check(found is not None, f'retinanet_parity: the card\'s detection {i} (label {label}, '
                                 f'score {float(score)}, box {box.tolist()}) has no match on '
                                 'the CPU')
        used.add(found)
        swapped += found != i
        box_err = max(box_err, float((box - rows['cpu'][1][found]).abs().max()))
        score_err = max(score_err, abs(float(score - rows['cpu'][2][found])))
    emit('retinanet_parity', batch=1, dtype='float32', tf32=False, n_valid=int(valid.sum()),
         logits_above_threshold=k, threshold_margin=float(top[k - 1] - top[k]) / 2,
         max_box_abs_err=box_err, max_score_abs_err=score_err,
         detections_in_another_order=swapped, raw_rel_err_cls_reg=raw_err)
    del cpu


def monodepth_predict_run(torch, dc, system, batches, P2, what):
    """predict over ``batches`` with the launch counts set to 0 just before,
    and a forward hook on each DCN recording the dtype it computes in:
    (ms per batch, outputs, launches, the DCNs' dtypes). Each predict must
    launch MONODEPTH_DCN_PER_FORWARD per-tap DCN forwards."""
    from visualdet3d_tpu_torch.models.blocks import ModulatedDeformConv
    dtypes, hooks = {}, []
    for name, m in system.inference_net().named_modules():
        if isinstance(m, ModulatedDeformConv):
            hooks.append(m.register_forward_hook(
                lambda mod, a, out, name=name: dtypes.__setitem__(name, str(out.dtype)[6:])))
    try:
        dc.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [system.predict(images, P2) for images in batches]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        launches = {k: dc.LAUNCHES[k] for k in DCN_FORWARD_KERNELS}
    finally:
        for h in hooks:
            h.remove()
    want = {'modulated_deform_conv': MONODEPTH_DCN_PER_FORWARD * len(batches),
            'modulated_deform_conv_alltaps': 0, 'modulated_deform_conv_premul_accum': 0}
    check(launches == want, f'{what}: DCN launches {launches} for {len(batches)} predicts '
                            f'(expected {want})')
    return ms, outs, launches, dtypes


def monodepth_slice_phase(torch, dc, system, dtype_name):
    """``MonoDepth.predict`` at batch 8 (the config's) and batch 1, 352x1216,
    over N_BATCHES distinct request batches: ms per batch, fps, bs1 p50,
    peak memory; 3 DCN launches a forward on the per-tap kernel, and the
    dtype each DCN computes in (f32 in both: the JAX package's bf16
    inference runs the decoder in f32 after ``LookGround``, so the f32
    kernel K5); positive, finite depth [B, H, W, 1]."""
    from visualdet3d_tpu_torch.entry import MONODEPTH_IMAGE_HW
    system.cfg.inference_dtype = dtype_name
    batches, P2 = a6_inputs(torch, N_BATCHES + 1, MONODEPTH_BATCH, MONODEPTH_IMAGE_HW, seed=67)
    system.predict(batches[0], P2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms_batch, outs, launches, dtypes = monodepth_predict_run(
        torch, dc, system, batches[1:], P2, f'monodepth_slice {dtype_name}')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(sorted(dtypes.values()) == ['float32'] * MONODEPTH_DCN_PER_FORWARD,
          f'monodepth_slice {dtype_name}: the DCNs compute in {dtypes}')
    for o in outs:
        t = o['target']
        check(t.shape == (MONODEPTH_BATCH, *MONODEPTH_IMAGE_HW, 1),
              f'monodepth_slice {dtype_name}: depth shape {tuple(t.shape)}')
        check(bool(torch.isfinite(t).all()) and float(t.min()) > 0,
              f'monodepth_slice {dtype_name}: depth not positive and finite')
    lats = bs1_latencies(torch, lambda x: system.predict(x, P2[:1]),
                         [b[:1].clone() for b in batches])
    depth = outs[0]['target']
    result = dict(dtype=dtype_name, batch=MONODEPTH_BATCH, image_hw=list(MONODEPTH_IMAGE_HW),
                  ms_per_batch=ms_batch, fps=MONODEPTH_BATCH / ms_batch * 1e3,
                  bs1_p50_ms=statistics.median(lats), bs1_ms=lats, launches_by_kernel=launches,
                  launches=launches['modulated_deform_conv'],
                  launches_per_predict=launches['modulated_deform_conv'] / N_BATCHES,
                  dcn_dtypes=dtypes, kernel_by_dcn={k: 'K5' if v == 'float32' else 'K3'
                                                    for k, v in dtypes.items()},
                  depth_min_m=float(depth.min()), depth_median_m=float(depth.median()),
                  depth_max_m=float(depth.max()), peak_memory_gb=peak_gb)
    emit('monodepth_slice', **result)
    return result, batches[1], P2


def monodepth_profile_phase(torch, system, images, P2, dtype_name):
    """A profiler breakdown of one batch-8 predict: the DCN kernel's device
    time and its share, the busy share, the top ops and kernels; by CUDA
    events the trunk alone against the whole predict."""
    system.cfg.inference_dtype = dtype_name
    system.predict(images, P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(images, P2))
    dcn = [e for e in kernels if 'deform_conv_kernel' in e.key]
    check(sum(e.count for e in dcn) == MONODEPTH_DCN_PER_FORWARD,
          f'monodepth_profile {dtype_name}: {sum(e.count for e in dcn)} DCN kernels')
    dcn_ms = sum(e.self_device_time_total for e in dcn) / 1e3
    net = system.inference_net()
    x = system._images(images, system.inference_dtype())
    runs = range(5)
    with torch.inference_mode():
        trunk_ms = cuda_ms(lambda _: net.ResNet_0(x), runs, warmup=1)
    predict_ms = cuda_ms(lambda _: system.predict(images, P2), runs, warmup=1)
    emit('monodepth_profile', dtype=dtype_name, batch=MONODEPTH_BATCH, wall_ms=wall_ms,
         device_ms=device_ms, device_busy_share=device_ms / wall_ms, dcn_kernel_ms=dcn_ms,
         dcn_share_of_device=dcn_ms / device_ms, events_predict_ms=predict_ms,
         events_trunk_ms=trunk_ms, decoder_share_of_predict=1 - trunk_ms / predict_ms,
         top_ops=top_events(ops, 12), top_kernels=top_events(kernels, 12))


def monodepth_parity_phase(torch, system):
    """Batch 1, f32, TF32 off: the card's MonoDepth against the same weights
    on the CPU: the three log-depth maps within 1e-3 of their largest
    value, the depth within 1e-3 relative."""
    from visualdet3d_tpu_torch.entry import MONODEPTH_IMAGE_HW, build_monodepth_system
    system.cfg.inference_dtype = 'float32'
    cpu = build_monodepth_system(device='cpu')
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.weights_changed()
    (image,), P2 = a6_inputs(torch, 1, 1, MONODEPTH_IMAGE_HW, seed=68)
    image, P2 = image.cpu(), P2.cpu()
    raw_gpu = {k: v.float().cpu() for k, v in system.predict_raw(image, P2).items()}
    depth_gpu = system.predict(image, P2)['target'].cpu()
    raw_cpu = cpu.predict_raw(image, P2)
    depth_cpu = cpu.predict(image, P2)['target']
    raw_err = {k: float((raw_gpu[k] - raw_cpu[k]).abs().max() / raw_cpu[k].abs().max())
               for k in raw_cpu}
    depth_err = float(((depth_gpu - depth_cpu).abs() / depth_cpu).max())
    check(max(raw_err.values()) <= 1e-3 and depth_err <= 1e-3,
          f'monodepth_parity: maps differ {raw_err}, depth by {depth_err} relative')
    emit('monodepth_parity', batch=1, dtype='float32', tf32=False, raw_rel_err=raw_err,
         depth_max_rel_err=depth_err, depth_median_m=float(depth_cpu.median()))
    del cpu


def monodepth_dcn_kernel_phase(torch, dc, peaks):
    """K5 (f32) and K3 (bf16) forward, K7's dx and dW, at the U-Net's three
    DCN shapes at batch 8 (22x76 768->256, 44x152 384->64, 88x304 64->64),
    offsets seeded (std 2 px, 5% of them 20-40 px): each against its plain
    version on the same inputs (``dcn_check`` in f32; in bf16
    ``head_dcn_bf16_check``, the f64 sums of the kernel's own bf16 samples
    with the tensor cores' accumulation allowance; ``bwd_check``), in CUDA
    events and device time (the forward from CUDA graphs, dx and dW apart
    from a profiler pass), beside its bound and a cuDNN dense 3x3 conv of
    the shape; then K4 (all taps) at each shape against its plain version
    and B4, and K6 (premul) bit for bit on the same table where the switch
    would take it (C_out < C_in: up0, up1), with their times. Returns the
    per-shape results by dtype and the sums over one forward."""
    import torch.nn.functional as F
    bw, f32_peak, bf16_peak = peaks
    gen = torch.Generator(device='cuda').manual_seed(69)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    b = MONODEPTH_BATCH
    results = {'f32': {}, 'bf16': {}, 'alltaps': {}, 'premul': {}}
    for name, h, w, c_in, c_out in MONODEPTH_DCNS:
        pixels = b * h * w
        for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
            runs, weight, bias = dcn_inputs(torch, gen, b, h, w, c_in, c_out, dtype,
                                            N_KERNEL_RUNS)
            what = f'monodepth {name} modulated_deform_conv {dt} {h}x{w} {c_in}->{c_out}'
            acc_ulps = None
            if dtype == torch.bfloat16:
                fwd_err, fwd_tol, acc_ulps = head_dcn_bf16_check(torch, dc, runs[0], weight,
                                                                 bias, what)
            else:
                fwd_err, fwd_tol = dcn_check(torch, dc, runs[0], weight, bias, what)
            fwd = lambda a: dc.modulated_deform_conv(*a, weight, bias)
            ms = cuda_ms(fwd, runs)
            device = graph_ms(fwd, runs[:4])
            plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_plain(*a, weight, bias),
                               runs[:3], warmup=1)
            w_oihw = weight.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            dense_ms = cuda_ms(lambda a: F.conv2d(a[0].permute(0, 3, 1, 2), w_oihw, bias,
                                                  padding=1), runs)
            isz = runs[0][0].element_size()
            n_bytes = isz * (pixels * (c_in + 27 + c_out) + 9 * c_in * c_out + c_out)
            n_flops = 2 * pixels * 9 * c_in * c_out
            bound_ms, bound_by = bound_of(n_bytes / bw * 1e3,
                                          n_flops / (f32_peak if dt == 'f32' else bf16_peak) * 1e3)
            grads = [torch.randn((b, h, w, c_out), generator=gen, device='cuda').to(dtype)
                     for _ in range(N_KERNEL_RUNS)]
            bwhat = f'monodepth {name} modulated_deform_conv_backward {dt}'
            bwd_err, bwd_tol, errs = bwd_check(torch, dc, runs[0], weight, grads[0], bwhat)
            pairs = list(zip(runs, grads))
            bwd = lambda a: dc.modulated_deform_conv_backward(*a[0], weight, a[1])
            bwd_ms = cuda_ms(bwd, pairs)
            bwd_plain_ms = cuda_ms(lambda a: dc.modulated_deform_conv_backward_plain(
                *a[0], weight, a[1]), pairs[:2], warmup=1)
            dev = bwd_device_ms(torch, bwd, pairs)
            bounds = bwd_bounds(pixels, c_in, c_out, isz, peaks, dt)
            err_of = {k: (e if dt == 'f32' else e['abs']) for k, e in errs.items()}
            adds = dx_adds(torch, dc, dtype, runs[0][1], h, w, c_in)
            r = dict(dcn=name, x=[b, h, w, c_in], c_out=c_out, max_abs_err=fwd_err,
                     tolerance=fwd_tol, accumulation_error_f32_ulps_of_abs_sum=acc_ulps,
                     ms=ms, device_ms=device, plain_ms=plain_ms, dense_conv_ms=dense_ms,
                     bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, flops=n_flops,
                     share_of_bound_device=bound_ms / device,
                     backward_ms_events=bwd_ms, backward_plain_ms=bwd_plain_ms,
                     backward_tolerance=bwd_tol, backward_errors=errs,
                     max_abs_err_dx=err_of['dx'], max_abs_err_dw=err_of['d_weight'],
                     dx_ms=dev['dx'], dw_ms=dev['dw'] + dev['dw_reduce'],
                     dw_reduce_ms=dev['dw_reduce'],
                     **{f'{k}_{f}': v for k in ('dx', 'dw')
                        for f, v in zip(('bound_ms', 'bound_by'), bound_of(*bounds[k]))},
                     dw_splits=dc.dw_plan(dc.dw_stages(b, h, w, dtype), c_in, c_out, 9, n_sm),
                     dx_adds={k: adds[k] for k in DX_ADD_KEYS},
                     **(dict(dx_tile=adds['tile'], dx_window=adds['window_hw']) if dt == 'bf16'
                        else dict(dx_tile_dy_resident_smem=dc.dx_f32_plan(c_out))))
            results[dt][name] = r
            emit('monodepth_dcn_kernel', kernel='modulated_deform_conv + backward', dtype=dt,
                 **r)
            if dtype == torch.bfloat16:  # K4 and K6 on the same inputs
                with dcn_switches(alltaps=True):
                    check(dc.forward_variant(h * w, c_in, c_out, dtype, True) == 'alltaps',
                          f'monodepth {name}: the all-taps gate refuses the shape')
                err, diff, equal = alltaps_check(torch, dc, runs[0], weight, bias,
                                                 f'monodepth {name} alltaps')
                k4_ms = cuda_ms(lambda a: dc.modulated_deform_conv_alltaps(*a, weight, bias),
                                runs)
                results['alltaps'][name] = dict(
                    dcn=name, ms=k4_ms, per_tap_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err, max_abs_diff_per_tap=diff,
                    bitwise_equal_per_tap=equal)
                emit('monodepth_dcn_alltaps', **results['alltaps'][name])
                if c_out < c_in:
                    share, op_err = premul_check(torch, dc, runs[0], weight, bias,
                                                 f'monodepth {name} premul')
                    tables = [dc.premul_table(a[0], weight) for a in runs]
                    k6_ms = cuda_ms(lambda i: dc.premul_lerp_accumulate(
                        tables[i], *runs[i][1:], bias), list(range(len(runs))))
                    k6_dev = graph_ms(lambda i: dc.premul_lerp_accumulate(
                        tables[i], *runs[i][1:], bias), list(range(4)))
                    k6_plain = cuda_ms(lambda i: dc.premul_lerp_accumulate_plain(
                        tables[i], *runs[i][1:], bias), [0, 1, 2], warmup=1)
                    del tables
                    k6_bytes = 2 * (pixels * 9 * c_out + pixels * 27 + pixels * c_out + c_out)
                    k6_bound, k6_by = bound_of(k6_bytes / bw * 1e3,
                                               10 * pixels * 9 * c_out / f32_peak * 1e3)
                    results['premul'][name] = dict(
                        dcn=name, ms=k6_ms, graph_ms=k6_dev, plain_ms=k6_plain,
                        table_ms=cuda_ms(lambda a: dc.premul_table(a[0], weight), runs),
                        op_ms=cuda_ms(lambda a: dc.modulated_deform_conv_premul(
                            *a, weight, bias), runs),
                        bound_ms=k6_bound, bound_by=k6_by, max_abs_err=0.0,
                        op_max_abs_err=op_err, op_share_within_2ulp=share)
                    emit('monodepth_dcn_premul', **results['premul'][name])
            del runs, grads, pairs
            torch.cuda.empty_cache()
    per_forward = {}
    for dt in ('f32', 'bf16'):
        rs = results[dt].values()
        per_forward[dt] = {k: sum(r[k] for r in rs) for k in (
            'ms', 'device_ms', 'plain_ms', 'dense_conv_ms', 'bound_ms', 'backward_ms_events',
            'backward_plain_ms', 'dx_ms', 'dw_ms', 'dw_reduce_ms', 'dx_bound_ms', 'dw_bound_ms')}
        per_forward[dt]['max_abs_err'] = max(r['max_abs_err'] for r in rs)
        per_forward[dt]['max_abs_err_dx'] = max(r['max_abs_err_dx'] for r in rs)
        per_forward[dt]['max_abs_err_dw'] = max(r['max_abs_err_dw'] for r in rs)
        for k in ('', 'dx_', 'dw_'):
            by = [r[f'{k}bound_by'] for r in rs]
            per_forward[dt][f'{k}bound_by'] = max(set(by), key=by.count)
        emit('monodepth_dcn_kernel_per_forward', dtype=dt, batch=b,
             dcn_launches=MONODEPTH_DCN_PER_FORWARD, **per_forward[dt])
    for kind in ('alltaps', 'premul'):
        rs = results[kind].values()
        per_forward[kind] = {k: sum(r[k] for r in rs) for k in ('ms', 'plain_ms', 'bound_ms')}
        per_forward[kind]['max_abs_err'] = max(r['max_abs_err'] for r in rs)
        by = [r['bound_by'] for r in rs]
        per_forward[kind]['bound_by'] = max(set(by), key=by.count)
    results['per_forward'] = per_forward
    return results


def a6_step_parity(torch, phase, gpu, gpu_state, gpu_step, cpu, cpu_state, cpu_step, ref,
                   batch, ref_loss, leaf_suffixes, param_gate, leaf_cap=None):
    """One f32 step (TF32 off) on the card and on the CPU from the same
    weights and batch, both held against the same step's loss and
    gradients on the CPU in f64 (``ref_loss(ref, cpu_batch)`` returns its
    (total, loss terms); ``ref`` holds the weights in f64), as
    ``gac_train_parity_phase`` holds GAC's: each loss term within max(8x
    the CPU's own f32 distance, 2e-4 of its value); the gradients before
    the update: the largest elementwise difference within 8x the CPU's
    (and 5e-2 of the largest gradient), the norm-wise difference within 3x
    the CPU's, each leaf ending in ``leaf_suffixes`` within 4x the larger of
    its own floor and the all-parameter floor (and, with ``leaf_cap``,
    within that of the f64 step on its own: the kernels' leaves); the
    running statistics after the step within 1e-4 of the CPU's; the
    parameters after the update within ``param_gate(lr, floor)``."""
    grads = {}
    for tag, sys_, state in (('gpu', gpu, gpu_state), ('cpu', cpu, cpu_state)):
        update = state.optimizer.step

        def recording_update(tag=tag, sys_=sys_, update=update):
            grads[tag] = [p.grad.detach().double().cpu() for p in sys_.net.parameters()]
            update()
        state.optimizer.step = recording_update
    lr = cpu_state.optimizer.schedule(0)
    m_gpu = {k: float(v) for k, v in gpu_step(batch).items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    m_cpu = {k: float(v) for k, v in cpu_step(cpu_batch).items()}
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    total, terms = ref_loss(ref, cpu_batch)
    total.backward()
    ref_s = time.perf_counter() - t0
    m_ref = {k: float(v.detach()) for k, v in terms.items()}
    m_ref['total'] = float(total.detach())
    g_ref = [(torch.zeros_like(p) if p.grad is None else p.grad).detach().double()
             for p in ref.net.parameters()]
    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-30) for k, v in m_ref.items()}
    loss_floor = {k: abs(m_cpu[k] - v) / max(abs(v), 1e-30) for k, v in m_ref.items()}
    g_gpu, g_cpu = grads['gpu'], grads['cpu']
    worst = max(float((a - r).abs().max()) for a, r in zip(g_gpu, g_ref))
    floor = max(float((c - r).abs().max()) for c, r in zip(g_cpu, g_ref))
    gmax = max(float(r.abs().max()) for r in g_ref)
    den = sum(float(r.norm()) ** 2 for r in g_ref)
    rel = (sum(float((a - r).norm()) ** 2 for a, r in zip(g_gpu, g_ref)) / den) ** 0.5
    rel_floor = (sum(float((c - r).norm()) ** 2 for c, r in zip(g_cpu, g_ref)) / den) ** 0.5
    names = [n for n, _ in cpu.net.named_parameters()]
    leaf = {n: (float((a - r).norm() / r.norm().clamp_min(1e-30)),
                float((c - r).norm() / r.norm().clamp_min(1e-30)), float(r.abs().max()))
            for a, c, r, n in zip(g_gpu, g_cpu, g_ref, names) if n.endswith(leaf_suffixes)}
    param_err = max(float((pg.detach().cpu() - pc.detach()).abs().max())
                    for pg, pc in zip(gpu.net.parameters(), cpu.net.parameters()))
    stats_err = max(float((bg.cpu() - bc).abs().max() / bc.abs().max().clamp_min(1e-30))
                    for bg, bc in zip(gpu.net.buffers(), cpu.net.buffers())
                    if bg.is_floating_point())
    emit(phase, batch=PARITY_TRAIN_BATCH, dtype='float32', tf32=False,
         reference='the CPU step in f64',
         loss_rel_err=loss_err, loss_rel_err_floor=loss_floor, grad_max_abs_err=worst,
         grad_max_abs_err_floor=floor, grad_max=gmax, grad_rel_err_all=rel,
         grad_rel_err_all_floor=rel_floor, leaves_rel_err_floor_max=leaf,
         param_max_abs_err=param_err, param_gate=param_gate(lr, floor), lr=lr,
         running_stats_rel_err=stats_err, cpu_step_s=cpu_s, f64_step_s=ref_s,
         total=m_gpu['total'])
    bad = {k: (loss_err[k], loss_floor[k]) for k in m_ref
           if loss_err[k] > max(8 * loss_floor[k], 2e-4)}
    check(not bad, f'{phase}: loss terms differ beyond the floor {bad}')
    check(worst <= max(8 * floor, 1e-5 * gmax) and worst <= 5e-2 * gmax
          and rel <= max(3 * rel_floor, 1e-6),
          f'{phase}: gradients differ: max abs {worst} (floor {floor}, gmax {gmax}), '
          f'norm-wise {rel} (floor {rel_floor})')
    cap = float('inf') if leaf_cap is None else leaf_cap
    bad = {n: e for n, e in leaf.items()
           if e[0] > min(4 * max(e[1], rel_floor), cap) or e[2] == 0}
    check(leaf and not bad, f'{phase}: {len(leaf)} leaves, these differ beyond their floor or '
                            f'beyond {leaf_cap}, or have no gradient (error, floor, max): {bad}')
    check(param_err <= param_gate(lr, floor),
          f'{phase}: parameters after the step differ by {param_err} (lr {lr})')
    check(stats_err <= 1e-4, f'{phase}: running statistics differ by {stats_err}')


def damp_residuals(torch, net):
    """Each residual branch's last BatchNorm scale times A6_RESIDUAL_SCALE
    (as ``gac_train_parity_phase``): at a random init the trunk's gradients
    otherwise grow through the blocks until rounding moves them by percents."""
    from visualdet3d_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BasicBlock):
                m.BatchNorm_1.weight.mul_(A6_RESIDUAL_SCALE)
            elif isinstance(m, Bottleneck):
                m.BatchNorm_2.weight.mul_(A6_RESIDUAL_SCALE)


def a6_train_batches(torch, model, n, batch_size, seed):
    """n distinct synthetic training batches on the card: RetinaNet's
    (``testing.mono_training_batch``: Cars, 384x1280) or MonoDepth's
    (``testing.depth_training_batch``: 5% of the pixels below the horizon
    with ground depth, 352x1216)."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import MONODEPTH_IMAGE_HW, RETINANET_IMAGE_HW
    if model == 'retinanet':
        make = lambda rng: testing.mono_training_batch(rng, batch_size, RETINANET_IMAGE_HW)
    else:
        make = lambda rng: testing.depth_training_batch(rng, batch_size, MONODEPTH_IMAGE_HW)
    rng = np.random.default_rng(seed)
    return [{k: torch.as_tensor(v, device='cuda') for k, v in make(rng).items()}
            for _ in range(n)]


def prepare_a6_for_training(torch, model, system, batch, seed, offset_std=2.0,
                            calibrate_head=False):
    """RetinaNet: ``testing.prepare_retinanet`` on the batch's images, the
    prediction convs calibrated only with ``calibrate_head`` (the step
    parity, so that the gradient reaches the towers): SGD at lr 0.01 trains
    from the config's own init (zero prediction kernels, the class bias at
    the 0.01 prior), and from calibrated ones its loss swings (34 to 181
    over 10 steps on one batch, bf16, on an H100); without the batch
    statistics a random ResNet-50 under ``norm_eval`` diverges (f32: 43 to
    18737). MonoDepth: ``testing.prepare_monodepth``."""
    from visualdet3d_tpu_torch import testing
    gen = torch.Generator().manual_seed(seed)
    if model == 'retinanet':
        testing.prepare_retinanet(system, batch['images'][:4], gen, calibrate_head)
    else:
        testing.prepare_monodepth(system, batch['images'][:4], batch['P2'][:4], gen,
                                  offset_std=offset_std)


def a6_train_phase(torch, dc, model, compute_dtype):
    """The RetinaNet or MonoDepth training step (``entry.build_<model>_trainer``)
    at batch 8, bf16 mixed precision or f32: ms per step and img/s over
    N_BATCHES distinct batches after N_TRAIN_WARMUP warm-up steps, ending
    in ``synchronize()``; MonoDepth's DCN launches of that run (3 forward on
    the per-tap kernel, 3 dx, 3 dW and 3 dW reduce a step: K3 and K7 in
    bf16, K5 and K7 in f32); peak memory; a profile of one step; the loss
    falling over N_FALL_STEPS steps on one batch (RetinaNet's at
    RETINANET_FALL_LR); for MonoDepth in bf16 then one step under
    ``VD3D_DCN_ALLTAPS=1`` (the all-taps forward K4)."""
    from visualdet3d_tpu_torch import entry
    name = compute_dtype or 'float32'
    phase = f'{model}_train'
    system, state, step = getattr(entry, f'build_{model}_trainer')(
        device='cuda', compute_dtype=compute_dtype, batch_size=A6_TRAIN_BATCH)
    batches = a6_train_batches(torch, model, N_TRAIN_WARMUP + N_BATCHES, A6_TRAIN_BATCH, seed=70)
    prepare_a6_for_training(torch, model, system, batches[0], seed=71)
    for b in batches[:N_TRAIN_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(b) for b in batches[N_TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = dict(dc.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = MONODEPTH_DCN_PER_FORWARD if model == 'monodepth' else 0
    per_step = {'modulated_deform_conv': n, 'modulated_deform_conv_alltaps': 0,
                'modulated_deform_conv_premul_accum': 0,
                'modulated_deform_conv_backward_input': n,
                'modulated_deform_conv_backward_weight': n,
                'modulated_deform_conv_backward_weight_reduce': n}
    check(launches == {k: v * N_BATCHES for k, v in per_step.items()},
          f'{phase} {name}: {launches} DCN launches for {N_BATCHES} steps (expected {per_step} '
          'a step)')
    losses = [float(m['total']) for m in metrics]
    check(all(np.isfinite(losses)) and min(losses) > 0, f'{phase} {name}: losses {losses}')
    check(state.optimizer.count == state.step == N_TRAIN_WARMUP + N_BATCHES,
          f'{phase} {name}: {state.optimizer.count} updates in {state.step} steps')
    for p in system.net.parameters():
        check(p.dtype == torch.float32 and bool(torch.isfinite(p).all()),
              f'{phase} {name}: a master parameter is {p.dtype} or non-finite')
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: step(batches[-1]))
    prefix = {'deform_conv_kernel': ('deform_conv_kernel<', 'deform_conv_kernelI'),
              'deform_conv_bwd_input_kernel': BWD_KERNEL_NAMES['dx'],
              'deform_conv_bwd_weight_kernel': BWD_KERNEL_NAMES['dw'],
              'deform_conv_bwd_weight_reduce_kernel': BWD_KERNEL_NAMES['dw_reduce']}
    found = {kind: [e for e in kernels if any(p in e.key for p in prefix[kind])]
             for kind in prefix}
    counts = {kind: sum(e.count for e in evs) for kind, evs in found.items()}
    check(all(c == n for c in counts.values()),
          f'{phase} {name} profile: DCN kernels in one step {counts}')
    kernel_ms = {kind: sum(e.self_device_time_total for e in evs) / 1e3
                 for kind, evs in found.items()}
    fall_lr = state.optimizer.schedule(state.optimizer.count)
    if model == 'retinanet':
        fall_lr = RETINANET_FALL_LR
        state.optimizer.schedule = lambda count: RETINANET_FALL_LR
    fall = [float(step(batches[-1])['total']) for _ in range(N_FALL_STEPS)]
    check(all(np.isfinite(fall)) and fall[-1] < fall[0],
          f'{phase} {name}: the loss did not fall over {N_FALL_STEPS} steps on one batch: {fall}')
    alltaps = None
    if model == 'monodepth' and compute_dtype == 'bfloat16':
        dc.reset_launch_counts()
        with dcn_switches(alltaps=True):
            loss = float(step(batches[0])['total'])
        torch.cuda.synchronize()
        alltaps = dict(dc.LAUNCHES)
        want = dict(per_step, modulated_deform_conv=0, modulated_deform_conv_alltaps=n)
        check(alltaps == want and np.isfinite(loss),
              f'{phase} {name}: one step under VD3D_DCN_ALLTAPS=1 launched {alltaps} '
              f'(expected {want}), loss {loss}')
    image_hw = list(batches[0]['images'].shape[1:3])
    result = dict(compute_dtype=name, batch=A6_TRAIN_BATCH, image_hw=image_hw,
                  ms_per_step=ms_step, img_per_s=A6_TRAIN_BATCH / ms_step * 1e3, losses=losses,
                  launches=launches,
                  launches_per_step={k: v / N_BATCHES for k, v in launches.items()},
                  peak_memory_gb=peak_gb, profile_wall_ms=wall_ms, device_ms=device_ms,
                  device_busy_share=device_ms / wall_ms,
                  device_busy_share_of_timed_step=device_ms / ms_step, kernel_ms=kernel_ms,
                  dcn_kernels_per_step=counts,
                  dcn_share_of_device=sum(kernel_ms.values()) / device_ms,
                  loss_on_one_batch=fall, fall_lr=fall_lr,
                  launches_of_one_alltaps_step=alltaps,
                  top_ops=top_events(ops, 14), top_kernels=top_events(kernels, 14))
    emit(phase, **result)
    del system, state, step, batches
    torch.cuda.empty_cache()
    return result


def a6_train_parity_phase(torch, model):
    """One f32 training step at batch 2 on the card against the CPU, both
    against the CPU's step in f64 (``a6_step_parity``), from the same
    weights (the residual branches damped, ``damp_residuals``; RetinaNet's
    prediction convs calibrated; MonoDepth prepared with offsets of 0.5 px)
    and batch. RetinaNet: SGD, so the parameters after the step within lr
    x 8x the gradient floor (+1e-6), its frozen stem and stage 1 moved by
    the weight decay alone; MonoDepth: Adam, within 2.5 * lr; its leaves
    held one by one: each DCN's weight and offset conv, each
    ``LookGround``'s disparity conv and alpha, also within
    MONODEPTH_LEAF_REL_CAP of the f64 step."""
    from visualdet3d_tpu_torch import entry
    batch = a6_train_batches(torch, model, 1, PARITY_TRAIN_BATCH, seed=72)[0]
    build = getattr(entry, f'build_{model}_trainer')
    gpu, gpu_state, gpu_step = build(device='cuda', batch_size=PARITY_TRAIN_BATCH)
    damp_residuals(torch, gpu.net)
    prepare_a6_for_training(torch, model, gpu, batch, seed=73, offset_std=0.5,
                            calibrate_head=True)
    init = {k: v.cpu() for k, v in gpu.net.state_dict().items()}
    cpu, cpu_state, cpu_step = build(device='cpu', batch_size=PARITY_TRAIN_BATCH)
    cpu.net.load_state_dict(init)
    cpu.weights_changed()
    ref = getattr(entry, f'build_{model}_system')(device='cpu')
    ref.net.load_state_dict(init)
    ref.net.double()
    if model == 'retinanet':
        def ref_loss(sys_, b):
            cls_loss, reg_loss, terms = sys_.loss(b['images'], b['P2'], b['annotations'],
                                                  apply_fn=lambda net, x: net(x.double()))
            return cls_loss.mean() + reg_loss.mean(), terms
        leaves = ('retina_cls.weight', 'retina_reg.weight', 'cls_conv_0.weight',
                  'FPN_0.lateral_0.weight', 'ResNet_0.layer2_0.Conv_0.weight')
        gate = lambda lr, floor: 1e-6 + lr * 8 * floor
        cap = None  # no kernel: the CPU's own f32 step is 0.7% from f64 at layer2 (an H100 run)
    else:
        def ref_loss(sys_, b):
            loss, terms = sys_.loss(b['images'], b['P2'], b['gts'],
                                    apply_fn=lambda net, x, P2: net(x.double(), P2=P2.double()))
            return loss, terms
        leaves = ('ModulatedDeformConv_0.weight', 'ModulatedDeformConv_0.Conv_0.weight',
                  'LookGround_0.Conv_0.weight', 'LookGround_0.alpha')
        gate = lambda lr, floor: 2.5 * lr
        cap = MONODEPTH_LEAF_REL_CAP
    a6_step_parity(torch, f'{model}_train_parity', gpu, gpu_state, gpu_step, cpu, cpu_state,
                   cpu_step, ref, batch, ref_loss, leaves, gate, cap)
    del gpu, cpu, ref
    torch.cuda.empty_cache()


def depth_config(work, name, tree, max_epochs, test_iter):
    """A config file that loads ``configs/monodepth.py`` and sets its paths
    to the synthetic depth tree ``tree``, ``max_epochs`` and ``test_iter``."""
    path = os.path.join(work, f'{name}.py')
    root = os.path.dirname(os.path.abspath(__file__))
    with open(path, 'w') as f:
        f.write(f"""import os
from visualdet3d_tpu_torch.config import cfg_from_file
cfg = cfg_from_file({os.path.join(root, 'configs', 'monodepth.py')!r})
out = os.path.join({work!r}, {name!r})
cfg.path.raw_path = {tree['raw_path']!r}
cfg.path.depth_path = {tree['depth_path']!r}
cfg.path.validation_path = {tree['validation_path']!r}
cfg.path.project_path = out
cfg.path.log_path = os.path.join(out, 'log')
cfg.path.checkpoint_path = os.path.join(out, 'checkpoint')
cfg.path.preprocessed_path = os.path.join(out, 'output')
cfg.detector.preprocessed_path = cfg.path.preprocessed_path
cfg.trainer.max_epochs = {max_epochs}
cfg.trainer.test_iter = {test_iter}
""")
    return path


def depth_data_phase(work):
    """``testing.write_synthetic_kitti_depth``: DEPTH_TREE_FRAMES full-size
    frames (both eyes' images and ground truth, the PNG rows cycling
    through the five filters) and VAL_FRAMES validation frames at
    375x1242; the training dataset's item ms by stage (each eye's image and
    ground truth decoded, each transform of ``configs/monodepth.py``'s
    augmentation), the validation item's ms; ``python -m
    visualdet3d_tpu_torch.cli.depth_precompute``'s seconds and its prior
    (finite, between 1 and 80 m). Returns (the tree, the config path)."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.augmentations import SAMPLE_KEYS
    from visualdet3d_tpu_torch.data.kitti.dataset.depth_dataset import read_depth
    from visualdet3d_tpu_torch.data.kitti.kittidata import read_image
    from visualdet3d_tpu_torch.models.detectors.monodepth import prior_mean_of
    from visualdet3d_tpu_torch.registry import DATASET_DICT
    import visualdet3d_tpu_torch.data  # noqa: F401
    t0 = time.perf_counter()
    tree = testing.write_synthetic_kitti_depth(os.path.join(work, 'kitti_depth'),
                                               DEPTH_TREE_FRAMES, seed=74, n_val=VAL_FRAMES)
    write_s = time.perf_counter() - t0
    config = depth_config(work, 'monodepth', tree, 1, 1)
    cfg = cfg_from_file(config)
    dataset = DATASET_DICT[cfg.data.train_dataset](cfg, 'training')
    check(len(dataset) == DEPTH_TREE_FRAMES, f'depth_data: {len(dataset)} training items')
    stages = []
    np.random.seed(0)
    for i in range(4):
        record, times = dataset.imdb[i], {}
        t0 = time.perf_counter()
        sample = dict.fromkeys(SAMPLE_KEYS)
        sample['left_image'] = read_image(record['image_2_file'])
        times['decode_image'] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        sample['image_gt'] = read_depth(record['gt_2_file'])
        times['decode_depth'] = (time.perf_counter() - t0) * 1e3
        sample['p2'] = record['P2'].copy()
        for j, transform in enumerate(dataset.transform.transforms):
            t0 = time.perf_counter()
            sample = transform(sample)
            times[f'{j}_{type(transform).__name__}'] = (time.perf_counter() - t0) * 1e3
        times['total'] = sum(times.values())
        stages.append(times)
        check(sample['left_image'].shape == (352, 1216, 3)
              and sample['image_gt'].shape == (352, 1216),
              f'depth_data: item {sample["left_image"].shape} {sample["image_gt"].shape}')
    t0 = time.perf_counter()
    item = dataset[0]
    item_ms = (time.perf_counter() - t0) * 1e3
    check(float((item['gt'] > 0).mean()) > 0.005, 'depth_data: no ground truth in the item')
    val = DATASET_DICT[cfg.data.val_dataset](cfg, 'validation')
    t0 = time.perf_counter()
    v = val[0]
    val_item_ms = (time.perf_counter() - t0) * 1e3
    check(len(val) == VAL_FRAMES and v['image'].shape == (352, 1216, 3),
          f'depth_data: {len(val)} validation items of {v["image"].shape}')
    cmd = [sys.executable, '-m', 'visualdet3d_tpu_torch.cli.depth_precompute', '--config', config]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    precompute_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'depth_precompute failed:\n{proc.stderr[-3000:]}')
    prior = prior_mean_of(cfg.path.preprocessed_path)
    check(np.isfinite(prior) and np.log(1.0) < prior < np.log(80.0),
          f'depth_data: prior mean log depth {prior}')
    emit('depth_data', frames=DEPTH_TREE_FRAMES, val_frames=VAL_FRAMES,
         image_hw=list(KITTI_HW), write_tree_s=write_s,
         item_stage_ms={k: statistics.median(s[k] for s in stages) for k in stages[0]},
         item_ms=item_ms, val_item_ms=val_item_ms,
         gt_valid_share=float((item['gt'] > 0).mean()), depth_precompute_s=precompute_s,
         prior_mean_depth_m=float(np.exp(prior)))
    return tree, config


def a6_cli_train_phase(torch, config, phase, per_step, evaluation):
    """``python -m visualdet3d_tpu_torch.cli.train`` in a subprocess on the
    card: one epoch of 2 steps at the config's batch and size, then the
    config's evaluation after it (``test_iter=1``). Gates: a finite loss,
    ``per_step`` kernel launches a step, the checkpoint, ``evaluation(out,
    eval_stats)``'s checks on the report and the evaluation's stats line."""
    from visualdet3d_tpu_torch import checkpoint
    from visualdet3d_tpu_torch.config import cfg_from_file
    cfg = cfg_from_file(config)
    log = os.path.join(os.path.dirname(config), f'{phase}.log')
    wall, out = run_train_cli(config, False, log)
    with open(os.path.join(cfg.path.log_path, 'train_stats.jsonl')) as f:
        [epoch] = [json.loads(line) for line in f]
    check(epoch['steps'] == 2 and np.isfinite(epoch['loss']),
          f'{phase}: {epoch["steps"]} steps, loss {epoch["loss"]}')
    got = {k: v / epoch['steps'] for k, v in epoch['launches'].items() if k in per_step}
    check(got == per_step, f'{phase}: launched {epoch["launches"]} in {epoch["steps"]} steps, '
                           f'expected {per_step} a step')
    check(checkpoint.CheckpointManager(cfg.path.checkpoint_path).all_steps() == [2],
          f'{phase}: no checkpoint of step 2')
    check('/**** finish testing after training epoch 0 ******/' in out,
          f'{phase}: no evaluation after the epoch:\n{out[-2000:]}')
    with open(os.path.join(cfg.path.log_path, 'eval_stats.jsonl')) as f:
        [stats] = [json.loads(line) for line in f]
    report = evaluation(out, stats)
    result = dict(batch=cfg.data.batch_size, image_hw=list(cfg.data.rgb_shape[:2]),
                  process_wall_s=wall, setup_s=epoch['setup_s'], step_ms=epoch['step_ms'],
                  loss=epoch['loss'],
                  launches_per_step={k: v / epoch['steps'] for k, v in epoch['launches'].items()},
                  loader_wait_share_of_epoch=epoch['loader_wait_s'] / epoch['wall_s'],
                  eval_frames=stats['frames'], eval_frame_ms=spread(stats['frame_ms']),
                  eval_item_ms=spread(stats['load_ms']), evaluator_s=stats['evaluator_s'],
                  eval_launches_per_frame={k: v / stats['frames']
                                           for k, v in stats['launches'].items()},
                  report=report)
    emit(phase, **result)
    return result


def depth_metrics(text):
    """The nine 'mean <metric> : <value>' lines of a depth report, parsed
    and finite."""
    rows = {line.split(':')[0].strip(): float(line.split(':')[1])
            for line in text.splitlines() if line.startswith('mean ')}
    check(len(rows) == 9 and all(np.isfinite(v) for v in rows.values()),
          f'the depth report did not parse or is not finite:\n{text[-2000:]}')
    return rows


def cli_train_monodepth_phase(torch, config):
    """``configs/monodepth.py`` through the train CLI (batch 8, 352x1216):
    3 DCN forward, dx, dW launches a step; ``evaluate_kitti_depth`` after
    the epoch: a 16-bit PNG a validation frame at 375x1242, the nine
    metrics, 3 DCN launches a frame."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.data.image_io import read_png
    cfg = cfg_from_file(config)
    n = MONODEPTH_DCN_PER_FORWARD

    def evaluation(out, stats):
        data = os.path.join(cfg.path.preprocessed_path, 'validation', 'data')
        pngs = [read_png(os.path.join(data, p)) for p in sorted(os.listdir(data))]
        check(len(pngs) == VAL_FRAMES and all(p.dtype == np.uint16 and p.shape == KITTI_HW
                                              and p.min() >= 1 for p in pngs),
              f'cli_train_monodepth: {len(pngs)} PNGs')
        per_frame = stats['launches'].get('modulated_deform_conv', 0) / stats['frames']
        check(per_frame == n, f'cli_train_monodepth: {per_frame} DCN launches a frame')
        return depth_metrics(out)
    return a6_cli_train_phase(torch, config, 'cli_train_monodepth',
                              {'modulated_deform_conv': n,
                               'modulated_deform_conv_backward_input': n,
                               'modulated_deform_conv_backward_weight': n}, evaluation)


def cli_train_retinanet_phase(torch, work, root, val_ids):
    """``configs/retinanet_2d.py`` on the KITTI object tree: the imdb
    precompute of RETINA_TREE_FRAMES training frames, then the train CLI
    (batch 8, 384x1280, SGD) for one epoch of 2 steps and
    ``evaluate_kitti_obj`` after it: the 2-D branch of ``test_one``, a
    result txt a validation frame and the AP table (Car, Pedestrian,
    Cyclist) parsed and finite."""
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.cli import imdb_precompute_3d
    from visualdet3d_tpu_torch.config import cfg_from_file
    split = testing.write_split_files(os.path.join(work, 'split_retinanet'),
                                      range(RETINA_TREE_FRAMES), val_ids)
    config = smoke_config(work, 'retinanet_2d.py', 'retinanet', root, split, 1)
    with open(config, 'a') as f:
        f.write('cfg.trainer.test_iter = 1\n')
    cfg = cfg_from_file(config)
    t0 = time.perf_counter()
    imdb_precompute_3d.run(cfg)
    precompute_s = time.perf_counter() - t0

    def evaluation(out, stats):
        data = os.path.join(cfg.path.preprocessed_path, 'validation', 'data')
        check(len(os.listdir(data)) == len(val_ids), f'cli_train_retinanet: result files '
                                                      f'{sorted(os.listdir(data))}')
        table = ap_table(out)
        return dict(imdb_precompute_s=precompute_s, table_rows=len(table),
                    ap_moderate={k: v[1] for k, v in table.items()})
    return a6_cli_train_phase(torch, config, 'cli_train_retinanet', {}, evaluation)


def timed_depth_config(config):
    """``config`` evaluated on its VAL_FRAMES validation frames listed
    EVAL_REPEATS times (links in a validation tree of their own, the names
    numbered so that the sorted lists repeat the frames in turn). Returns
    the new config's path."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    cfg = cfg_from_file(config)
    src = cfg.path.validation_path
    dst = src.rstrip('/') + '_timed'
    for sub in ('image', 'groundtruth_depth', 'intrinsics'):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
        names = sorted(os.listdir(os.path.join(src, sub)))
        check(len(names) == VAL_FRAMES, f'timed_depth_config: {len(names)} files in {sub}')
        for r in range(EVAL_REPEATS):
            for i, n in enumerate(names):
                link = os.path.join(dst, sub, f'{r:03d}_{i}_{n}')
                if not os.path.exists(link):
                    os.symlink(os.path.join(src, sub, n), link)
    path = f'{config[:-3]}_timed.py'
    with open(config) as f, open(path, 'w') as g:
        g.write(f.read() + f'cfg.path.validation_path = {dst!r}\n'
                           "cfg.path.log_path = os.path.join(out, 'timed_log')\n")
    return path


def run_depth_eval_cli(torch, config, ckpt, device=None):
    """``cli.eval.main`` in this process (the card unless ``device``), the
    launch counts set to 0 just before: (its eval_stats line, its output,
    the metrics, the counts)."""
    import contextlib
    import io
    from visualdet3d_tpu_torch.cli import eval as eval_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = cfg_from_file(config)
    argv = ['--config', config, '--checkpoint_path', ckpt] + (['--device', device] if device
                                                             else [])
    reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_cli.main(argv)
    launches = launch_counts()
    out = buf.getvalue()
    with open(os.path.join(cfg.path.log_path, 'eval_stats.jsonl')) as f:
        stats = json.loads(f.readlines()[-1])
    return stats, out, depth_metrics(out), launches


def cli_eval_monodepth_phase(torch, config):
    """The eval CLI on the card at batch 1 on ``configs/monodepth.py``'s
    train-CLI checkpoint, over VAL_FRAMES * EVAL_REPEATS frames
    (``timed_depth_config``): the median and p10-p90 of the frame's ms (the
    predict and the copy to the host), of the item's and of the PNG's, 3
    DCN launches a frame; then the VAL_FRAMES frames on the card and with
    ``--device cpu``: the nine metrics of the card's PNGs within 1e-4
    relative of the CPU's."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    ckpt = cfg_from_file(config).path.checkpoint_path
    stats, _, timed_metrics, launches = run_depth_eval_cli(torch, timed_depth_config(config),
                                                           ckpt)
    frames = VAL_FRAMES * EVAL_REPEATS
    check(stats['frames'] == frames, f'cli_eval_monodepth: {stats["frames"]} frames')
    per_frame = stats['launches'].get('modulated_deform_conv', 0) / frames
    check(per_frame == MONODEPTH_DCN_PER_FORWARD,
          f'cli_eval_monodepth: {per_frame} DCN launches a frame')
    card_stats, _, card, _ = run_depth_eval_cli(torch, config, ckpt)
    t0 = time.perf_counter()
    cpu_stats, _, cpu, _ = run_depth_eval_cli(torch, config, ckpt, device='cpu')
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    check(max(rel.values()) <= 1e-4, f'cli_eval_monodepth: the card\'s metrics differ from the '
                                     f'CPU\'s {rel}')
    emit('cli_eval_monodepth', frames=frames, frame_ms=spread(stats['frame_ms'][1:]),
         first_frame_ms=stats['frame_ms'][0], item_ms=spread(stats['load_ms'][1:]),
         png_ms=spread(stats['write_ms'][1:]), evaluator_s=stats['evaluator_s'],
         setup_s=stats['setup_s'], launches_per_frame={k: v / frames for k, v in
                                                       stats['launches'].items()},
         launches_in_cli_run={k: v for k, v in launches.items() if v},
         metrics_timed=timed_metrics, metrics_card=card, metrics_cpu=cpu,
         metrics_rel_diff_card_cpu=rel, cpu_eval_s=cpu_s, cpu_frame_ms=spread(
             cpu_stats['frame_ms']), card_frame_ms=spread(card_stats['frame_ms']))
    return dict(launches_per_frame=per_frame)


def a6_phases(torch, dc, peaks):
    """The A6 slice: RetinaNet's predict in f32 and bf16 with a profile and
    the card-CPU parity, its training step in bf16 and f32 and the step
    parity; MonoDepth's the same, with K3/K5/K7 (K4, K6) at its three DCN
    shapes. Returns the numbers the ``kernels`` line reads."""
    out = {'retinanet_slice': {}, 'monodepth_slice': {}, 'retinanet_train': {},
           'monodepth_train': {}}
    system = build_retinanet(torch)
    for dtype_name in ('float32', 'bfloat16'):
        out['retinanet_slice'][dtype_name], images = retinanet_slice_phase(torch, system,
                                                                           dtype_name)
        retinanet_profile_phase(torch, system, images, dtype_name)
        del images
    retinanet_parity_phase(torch, system)
    del system
    torch.cuda.empty_cache()
    system = build_monodepth(torch)
    for dtype_name in ('float32', 'bfloat16'):
        out['monodepth_slice'][dtype_name], images, P2 = monodepth_slice_phase(
            torch, dc, system, dtype_name)
        monodepth_profile_phase(torch, system, images, P2, dtype_name)
        del images
    monodepth_parity_phase(torch, system)
    del system
    torch.cuda.empty_cache()
    out['dcn'] = monodepth_dcn_kernel_phase(torch, dc, peaks)
    for model in ('retinanet', 'monodepth'):
        for name, cd in (('bfloat16', 'bfloat16'), ('float32', None)):
            out[f'{model}_train'][name] = a6_train_phase(torch, dc, model, cd)
        a6_train_parity_phase(torch, model)
    return out


# ---------------------------------------------------------------------------
# int8 inference of the mono families (GAC, Yolo3D, KM3D, MonoFlex), and
# data-parallel training with synchronised BatchNorm (parallel/mesh.py)
# ---------------------------------------------------------------------------

MONO_INT8_MODELS = {'km3d': 'km3d', 'monoflex': 'monoflex', 'ground_aware': 'gac',
                    'dcn': 'yolo3d'}  # model -> the name in the phases' lines
MONO_CALIB = (2, 2)  # seeded calibration batches x images a batch
MONO_DCN_PER_FORWARD = {'km3d': DCN_PER_FORWARD, 'monoflex': DCN_PER_FORWARD,
                        'ground_aware': 0, 'dcn': 1}
MONO_PARITY_DIV = 3  # the parity's images: a third of the model's size a side (the CPU's
                     # int8 convs are float64 convs: 38 s for one GAC frame at full size)
DDP_WORLD = 2        # ranks of the data-parallel stereo step, both on the one card
DDP_BATCH = 16       # bench.py's stereo bf16 cell: 8 items a rank


def mono_inputs(torch, model, n, batch, seed, div=1):
    """n distinct request batches of standard-normal images on the card at
    the model's size (KM3D and MonoFlex 384x1280, GAC and Yolo3D 288x1280;
    each side divided by ``div`` and rounded down to a multiple of 32), the
    KITTI P2 scaled to it and tiled to the batch, and the size."""
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, KM3D_IMAGE_HW
    full = KM3D_IMAGE_HW if model in ('km3d', 'monoflex') else IMAGE_HW
    hw = tuple(d // div // 32 * 32 for d in full)
    P2 = KITTI_P2.copy()
    P2[0] *= hw[1] / full[1]
    P2[1] *= hw[0] / full[0]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    images = [torch.randn((batch, *hw, 3), generator=gen, device='cuda') for _ in range(n)]
    return images, torch.as_tensor(np.tile(P2, (batch, 1, 1)), device='cuda'), hw


def build_mono_int8(torch, model):
    """The published model on the card made ready to predict (``build_km3d``
    or ``build_gac``), its BatchNorms folded, calibrated in full f32 on
    MONO_CALIB seeded batches and quantized (the 64-channel bound, the
    model's deny list). Returns the system and the quantization's numbers."""
    from visualdet3d_tpu_torch.models.quant import collect_block_entries, flatten_quant
    from visualdet3d_tpu_torch.pipelines.inference_prep import full_f32
    system = build_km3d(torch, model) if model in ('km3d', 'monoflex') else build_gac(torch, model)
    calib, P2, hw = mono_inputs(torch, model, MONO_CALIB[0], MONO_CALIB[1], seed=61)
    t0 = time.perf_counter()
    system.fold_inference_variables(hw)
    with torch.no_grad(), full_f32():
        absmax = system.calibrate_int8([system.int8_calib_inputs({'images': im, 'P2': P2})
                                        for im in calib])
    quant = system.quantize_int8(absmax)
    torch.cuda.synchronize()
    flat = flatten_quant(quant)
    check(not any(any(c.startswith('ModulatedDeformConv') for c in p) for p in flat),
          f'{model}: a DCN offset conv was quantized')
    for path in system.int8_deny:
        check(path not in flat, f'{model}: the denied {path} was quantized')
    return system, dict(fold_calibrate_quantize_s=time.perf_counter() - t0,
                        quantized_convs=len(flat),
                        block_fuse_entries=len(collect_block_entries(quant)))


def mono_int8_shapes(torch, system, model):
    """The int8 conv shapes of one batch-16 int8 predict with their counts
    (``int8_conv_shapes``)."""
    batches, P2, _ = mono_inputs(torch, model, 1, BATCH, seed=63)
    system.cfg.int8_block = None
    return int8_conv_shapes(torch, system, (batches[0], P2))


def int8_mono_slice_phase(torch, dc, ic, system, model, mode, shapes):
    """``predict`` of the quantized model at batch 16 over N_BATCHES
    distinct request batches in ``mode``: 'int8' (the int8 copy: B8 and the
    quantize for every quantized conv, the float remainder in bf16, its
    DCNs on K3) or 'bfloat16' (the same folded network in bf16): ms per
    batch, fps, bs1 p50, peak memory, valid detections, finite outputs, and
    the launches of B8 (by path), the quantize and the DCN forward kernels
    in that run, the counts set to 0 just before it. B8 and the quantize
    must launch once per quantized conv that the predict runs (``shapes``),
    the DCNs MONO_DCN_PER_FORWARD times on the per-tap kernel."""
    name = MONO_INT8_MODELS[model]
    system.cfg.inference_dtype = mode
    system.cfg.int8_block = None
    batches, P2, hw = mono_inputs(torch, model, N_BATCHES + 1, BATCH, seed=64)
    system.predict(batches[0], P2)  # warm-up: the int8 or cast copy, cuDNN's choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ic.reset_launch_counts()
    dc.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [system.predict(images, P2) for images in batches[1:]]
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / N_BATCHES
    launches = {**ic.LAUNCHES, **{k: dc.LAUNCHES[k] for k in DCN_FORWARD_KERNELS}}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_predict = {k: v / N_BATCHES for k, v in launches.items()}
    n_b8 = sum(shapes.values()) if mode == 'int8' else 0
    by_path = sum(per_predict[f'int8_conv2d_{k}'] for k in ('wgmma', 'wgmma_splitk', 'cp_async'))
    n_dcn = MONO_DCN_PER_FORWARD[model]
    check(per_predict['int8_conv2d'] == n_b8 == per_predict['int8_quantize'] == by_path
          and (mode != 'int8' or per_predict['int8_conv2d_wgmma'] > 0)
          and (per_predict['modulated_deform_conv'], per_predict['modulated_deform_conv_alltaps'],
               per_predict['modulated_deform_conv_premul_accum']) == (n_dcn, 0, 0),
          f'int8_mono_slice {name} {mode}: launches per predict {per_predict}, expected {n_b8} '
          f'B8 (on the wgmma path among them) and quantize, {n_dcn} per-tap DCN')
    n_valid = [int(o['valid'].sum()) for o in outs]
    for o in outs:
        check(o['bboxes'].shape == (BATCH, 32, 11) and o['scores'].shape == (BATCH, 32),
              f'int8_mono_slice {name} {mode}: output shapes {o["bboxes"].shape}')
        for key in ('scores', 'bboxes'):
            check(bool(torch.isfinite(o[key]).all()),
                  f'int8_mono_slice {name} {mode}: non-finite {key}')
    check(min(n_valid) > 0, f'int8_mono_slice {name} {mode}: a batch with no valid detection '
                            f'{n_valid}')
    lats = bs1_latencies(torch, lambda images: system.predict(images, P2[:1]),
                         [images[:1].clone() for images in batches])
    result = dict(model=name, mode=mode, batch=BATCH, image_hw=list(hw), ms_per_batch=ms_batch,
                  fps=BATCH / ms_batch * 1e3, bs1_p50_ms=statistics.median(lats), bs1_ms=lats,
                  valid_per_batch=n_valid, launches=launches, launches_per_predict=per_predict,
                  peak_memory_gb=peak_gb)
    emit('int8_mono_slice', **result)
    return result


def _raw_list(raw):
    """predict_raw's outputs as a list of f32 CPU tensors (KM3D's maps in
    key order)."""
    if isinstance(raw, dict):
        raw = [raw[k] for k in sorted(raw)]
    return [t.float().cpu() for t in raw]


def int8_mono_parity_phase(torch, system, model):
    """The card's artifact and folded weights moved to a CPU system of the
    same model: the batch-1 int8 predict on the card against the CPU's, on
    images of a third of the model's size a side (MONO_PARITY_DIV; the
    kernels are held to their plain versions at the full shapes in
    ``int8_mono_conv_kernel``), self-calibrated as ``int8_parity``: the
    floor is the CPU against itself with 1% of the pixels moved by one bf16
    ulp. Gates: raw outputs within 1.5x the floor (``int8_parity`` also caps
    them at 5e-2 of their largest value, the JAX package's bound for the
    stereo int8 network against its f32; it holds the mono families to
    their decoded scores, within 0.05, which the matched share reads);
    valid counts within 2; the share of the CPU's boxes that the card
    matches (IoU > 0.7, score within 0.05) at least half and at least the
    floor's less 0.2 (two standard deviations of the difference of two
    shares of 32 boxes)."""
    from visualdet3d_tpu_torch import entry
    name = MONO_INT8_MODELS[model]
    (images,), P2, hw = mono_inputs(torch, model, 1, 1, seed=65, div=MONO_PARITY_DIV)
    if model not in ('km3d', 'monoflex'):
        # the class logits' tail onto the anchors the decode keeps at this size (the
        # float prediction conv), as cli_eval_gac_postopt shifts them
        system.cfg.inference_dtype = 'int8'
        with torch.no_grad():
            cls = system.predict_raw(images, P2)[0][..., 0].float()
            useful = system.anchors.useful_mask(system.anchor_pack(hw), P2)
            system.prediction_convs()[0].bias += 1.5 - torch.quantile(cls[useful], 0.9)
        system.weights_changed()
    t0 = time.perf_counter()
    if model in ('km3d', 'monoflex'):
        cpu = getattr(entry, f'build_{model}_system')(device='cpu')
    else:
        cpu = entry.build_gac_system(device='cpu', head=model)
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    cpu.set_int8_quant({p: {k: v.cpu() for k, v in e.items()}
                        for p, e in system.int8_quant.items()})
    images, P2 = images.cpu(), P2.cpu()
    gen = torch.Generator().manual_seed(66)
    moved = torch.rand(images.shape, generator=gen) < 0.01
    images_moved = torch.where(moved, images.to(torch.bfloat16).float() * (1 + 2 ** -7), images)

    def run(sys_, x):
        sys_.cfg.inference_dtype, sys_.cfg.int8_block = 'int8', None
        dev = sys_.device
        raw = _raw_list(sys_.predict_raw(x.to(dev)) if model in ('km3d', 'monoflex')
                        else sys_.predict_raw(x.to(dev), P2.to(dev)))
        out = sys_.predict(x.to(dev), P2.to(dev))
        return raw, {k: v[0].cpu() for k, v in out.items()}

    def compare(got, ref):
        (raw_g, out_g), (raw_r, out_r) = got, ref
        rel = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(raw_g, raw_r)]
        vg, vr = out_g['valid'], out_r['valid']
        bg, br = out_g['bboxes'][vg, :4], out_r['bboxes'][vr, :4]
        lt = torch.maximum(br[:, None, :2], bg[None, :, :2])
        rb = torch.minimum(br[:, None, 2:4], bg[None, :, 2:4])
        inter = (rb - lt).clamp_min(0).prod(-1)
        area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])  # noqa: E731
        iou = inter / (area(br)[:, None] + area(bg)[None] - inter).clamp_min(1e-6)
        score_ok = (out_r['scores'][vr][:, None] - out_g['scores'][vg][None]).abs() < 0.05
        matched = ((iou > 0.7) & score_ok).any(1).float().mean() if len(bg) and len(br) else 0.0
        return dict(raw_rel_err=rel, n_valid=[int(vg.sum()), int(vr.sum())],
                    matched_share=float(matched))

    ref = run(cpu, images)
    floor = compare(run(cpu, images_moved), ref)
    cpu_s = time.perf_counter() - t0
    card = compare(run(system, images), ref)
    raw_ok = all(e <= 1.5 * f for e, f in zip(card['raw_rel_err'], floor['raw_rel_err']))
    n_g, n_c = card['n_valid']
    emit('int8_mono_parity', model=name, batch=1, image_hw=list(hw), card_vs_cpu=card,
         cpu_vs_cpu_moved=floor, cpu_s=cpu_s)
    check(raw_ok and n_c > 0 and abs(n_g - n_c) <= 2
          and card['matched_share'] >= max(floor['matched_share'] - 0.2, 0.5),
          f'int8_mono_parity {name}: card {card} against the floor {floor}')
    del cpu


def int8_mono_conv_kernel_phase(torch, ic, shapes_of, part):
    """B8 at every conv shape of the four mono families' batch-16 int8
    predicts (``shapes_of``: model -> {shape: count}): the s32 sums bit for
    bit and the epilogues against the plain version (``int8_conv_check``),
    its time in CUDA events and in device time (CUDA graphs), the plain
    version's, a cuDNN bf16 conv of the same shape (a yardstick, not the
    same function), the plan (path, split) and the bound; the quantize of
    each input shape bit for bit, in events and device time. Returns per
    model the sums a predict."""
    import torch.nn.functional as F
    bw = CARD_PEAKS[part][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device='cuda').manual_seed(67)
    inv = torch.tensor(127 / 9.0, device='cuda')
    union = {}
    for model, shapes in shapes_of.items():
        for key, count in shapes.items():
            union.setdefault(key, {})[MONO_INT8_MODELS[model]] = count
    per_shape, quant_of = {}, {}
    for key in sorted(union):
        b, h, w, c, n, kh, kw, stride, padding, dilation, has_bias = key
        xs = [torch.randint(-127, 128, (b, h, w, c), generator=gen, device='cuda',
                            dtype=torch.int8) for _ in range(3)]
        wq = torch.randint(-127, 128, (n, kh, kw, c), generator=gen, device='cuda',
                           dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3
        bias = torch.randn((n,), generator=gen, device='cuda') if has_bias else None
        what = (f'{b}x{h}x{w}x{c}->{n} k{kh}x{kw} s{tuple(stride)} p{padding} d{tuple(dilation)}'
                f'{" +bias" if has_bias else ""}')
        err = int8_conv_check(torch, ic, xs[0], wq, stride, padding, dilation, bias, what)
        fn = lambda x: ic.int8_conv2d(x, wq, stride, padding, dilation, scale, bias,  # noqa: E731
                                      torch.bfloat16)
        ms, device_ms = cuda_ms(fn, xs), graph_ms(fn, xs)
        plain_ms = cuda_ms(lambda x: ic.int8_conv2d_plain(x, wq, stride, padding, dilation, scale,
                                                          bias, torch.bfloat16), xs[:1], warmup=1)
        xf = [x.permute(0, 3, 1, 2).to(torch.bfloat16) for x in xs]
        wf = wq.permute(0, 3, 1, 2).to(torch.bfloat16)
        bf = bias.to(torch.bfloat16) if bias is not None else None
        pad = (padding[0][0], padding[1][0])
        library_ms = cuda_ms(lambda x: F.conv2d(x, wf, bf, tuple(stride), pad, tuple(dilation)), xf)
        plan = ic.plan_int8_conv(b, h, w, c, n, kh, kw, tuple(stride), padding, tuple(dilation),
                                 sms=sms)
        ho, wo = ic.output_hw(h, w, kh, kw, stride, padding, dilation)
        ops = 2 * b * ho * wo * n * kh * kw * c
        nbytes = (b * h * w * c + n * kh * kw * c + b * ho * wo * n * 2
                  + 4 * n * (2 if has_bias else 1))
        bytes_ms, ops_ms = nbytes / bw * 1e3, ops / int8_peak(part) * 1e3
        per_shape[key] = dict(shape=what, per_predict=union[key], ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, cudnn_bf16_ms=library_ms, path=plan.path,
                              plan=plan._asdict(), bound_ms=max(bytes_ms, ops_ms),
                              bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                              share_of_bound_device=max(bytes_ms, ops_ms) / device_ms,
                              max_abs_err_f32=err)
        emit('int8_mono_conv_kernel', kernel='int8_conv2d', **per_shape[key])
        qkey = (b, h, w, c)
        if qkey not in quant_of:
            xb = [(torch.randn(qkey, generator=gen, device='cuda') * 3).to(torch.bfloat16)
                  for _ in range(3)]
            got, ref = ic.quantize_act(xb[0], inv), ic.quantize_act_plain(xb[0], inv)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f'int8_quantize {qkey}: differs from the plain version')
            qfn = lambda t: ic.quantize_act(t, inv)  # noqa: E731
            quant_of[qkey] = dict(ms=cuda_ms(qfn, xb), device_ms=graph_ms(qfn, xb),
                                  plain_ms=cuda_ms(lambda t: ic.quantize_act_plain(t, inv), xb),
                                  bound_ms=3 * b * h * w * c / bw * 1e3)
        del xs, xf
    totals = {}
    for model, shapes in shapes_of.items():
        t = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 max_abs_err=0.0, quantize_ms=0.0, quantize_device_ms=0.0,
                 quantize_plain_ms=0.0, quantize_bound_ms=0.0, launches_per_predict=0,
                 by_path={})
        bound_by = {'bytes': 0.0, 'operations': 0.0}
        for key, count in shapes.items():
            r, q = per_shape[key], quant_of[key[:4]]
            t['ms'] += count * r['ms']
            t['device_ms'] += count * r['device_ms']
            t['plain_ms'] += count * r['plain_ms']
            t['library_ms'] += count * r['cudnn_bf16_ms']
            t['bound_ms'] += count * r['bound_ms']
            t['max_abs_err'] = max(t['max_abs_err'], r['max_abs_err_f32'])
            t['quantize_ms'] += count * q['ms']
            t['quantize_device_ms'] += count * q['device_ms']
            t['quantize_plain_ms'] += count * q['plain_ms']
            t['quantize_bound_ms'] += count * q['bound_ms']
            t['launches_per_predict'] += count
            t['by_path'][r['path']] = t['by_path'].get(r['path'], 0) + count
            bound_by[r['bound_by']] += count * r['bound_ms']
        t['bound_by'] = max(bound_by, key=bound_by.get)
        t['shapes'] = [per_shape[key]['shape'] for key in sorted(shapes)]
        totals[model] = t
        emit('int8_mono_conv_kernel_per_predict', model=MONO_INT8_MODELS[model], batch=BATCH,
             **{k: v for k, v in t.items() if k != 'shapes'})
    return totals, [per_shape[k] for k in sorted(per_shape)]


def int8_mono_phases(torch, dc, ic, part):
    """The mono families in int8: for each of KM3D, MonoFlex, GAC and
    Yolo3D the quantized model's int8 and bf16 predicts (slice) and the
    card-CPU parity at batch 1; then B8 and the quantize at every conv
    shape they ran. Returns the slices, the kernel sums and the shapes."""
    slices, shapes_of, quant = {}, {}, {}
    for model in MONO_INT8_MODELS:
        system, quant[model] = build_mono_int8(torch, model)
        shapes_of[model] = mono_int8_shapes(torch, system, model)
        slices[model] = {mode: int8_mono_slice_phase(torch, dc, ic, system, model, mode,
                                                     shapes_of[model])
                         for mode in ('int8', 'bfloat16')}
        emit('int8_mono_quantize', model=MONO_INT8_MODELS[model], **quant[model])
        int8_mono_parity_phase(torch, system, model)
        del system
        torch.cuda.empty_cache()
    totals, per_shape = int8_mono_conv_kernel_phase(torch, ic, shapes_of, part)
    return dict(slices=slices, totals=totals, per_shape=per_shape, quant=quant)


def ddp_stereo_rank(rank, world, port, in_path, out_path):
    """One rank of ``ddp_stereo_train``: joins the gloo group on the card
    (``parallel.mesh.initialize_distributed(..., backend='gloo')``: NCCL
    puts no two ranks on one GPU), runs the bf16 stereo step on its rows of
    the batch from the weights in ``in_path`` (dropout off) and saves the
    loss terms, the gradients the optimizer received, the parameters,
    buffers and correlation launches to ``out_path``."""
    import torch
    from visualdet3d_tpu_torch.entry import build_stereo_trainer
    from visualdet3d_tpu_torch.ops import cost_volume as cv
    from visualdet3d_tpu_torch.parallel import mesh
    mesh.initialize_distributed(f'127.0.0.1:{port}', world, rank, backend='gloo',
                                device='cuda:0')
    try:
        spec = torch.load(in_path)
        system, state, step = build_stereo_trainer(device='cuda', compute_dtype='bfloat16',
                                                   batch_size=DDP_BATCH // world)
        system.net.load_state_dict(spec['init'])
        system.weights_changed()
        system.dropout = False
        grads, update = [], state.optimizer.step

        def recording_update():
            grads.extend(p.grad.detach().cpu() for p in system.net.parameters())
            update()
        state.optimizer.step = recording_update
        batch = {k: v.cuda() for k, v in mesh.shard_batch(mesh.make_mesh(), spec['batch']).items()}
        cv.reset_launch_counts()
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        torch.save(dict(metrics=metrics, grads=grads,
                        params=[p.detach().cpu() for p in system.net.parameters()],
                        buffers=[b.cpu() for b in system.net.buffers()],
                        launches=dict(cv.LAUNCHES), count=state.optimizer.count), out_path)
    finally:
        mesh.shutdown()


def ddp_stereo_train_phase(torch):
    """The data-parallel stereo step on the card: DDP_WORLD processes
    (``ddp_stereo_rank``), each with DDP_BATCH / DDP_WORLD items of one
    bf16 batch of DDP_BATCH (``testing.stereo_training_batch``, bench.py's
    cell), against the single-process bf16 step on the whole batch, the
    same weights, dropout off. Self-calibrated, as ``stereo_train_parity``:
    the floor is the single-process step on the reversed batch (the same
    math in another order). Gates: each loss term within max(8x the floor's
    difference, 2e-4 of its value); the gradients the optimizer receives
    (averaged over the ranks): the largest elementwise difference within
    8x the floor's and 5e-2 of the largest gradient, the norm-wise
    difference within 3x the floor's; the parameters after the Adam step
    within 2.5 * lr; the running statistics within max(3x the floor's,
    1e-4) of their largest value; both ranks' parameters equal; 2 K1 and 2
    CB launches in each rank's step."""
    import tempfile
    from visualdet3d_tpu_torch import testing
    from visualdet3d_tpu_torch.entry import build_stereo_trainer
    batch = train_batches_of(torch, testing.stereo_training_batch, 1, DDP_BATCH, seed=72)[0]
    flipped = {k: v.flip(0) for k, v in batch.items()}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='vd3d_ddp_') as work:
        single, state, step = build_stereo_trainer(device='cuda', compute_dtype='bfloat16',
                                                   batch_size=DDP_BATCH)
        init = {k: v.cpu() for k, v in single.net.state_dict().items()}
        in_path = os.path.join(work, 'in.pt')
        torch.save(dict(init=init, batch={k: v.cpu() for k, v in batch.items()}), in_path)
        with __import__('socket').socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        outs = [os.path.join(work, f'rank{r}.pt') for r in range(DDP_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, '-c', f'import chip_smoke; chip_smoke.ddp_stereo_rank({r}, '
             f'{DDP_WORLD}, {port}, {in_path!r}, {outs[r]!r})'], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DDP_WORLD)]
        refs = {}
        for tag, b in (('single', batch), ('flipped', flipped)):
            if tag == 'flipped':
                single, state, step = build_stereo_trainer(device='cuda', compute_dtype='bfloat16',
                                                           batch_size=DDP_BATCH)
                single.net.load_state_dict({k: v.cuda() for k, v in init.items()})
                single.weights_changed()
            single.dropout = False
            grads, update = [], state.optimizer.step

            def recording_update(grads=grads, system=single, update=update):
                grads.extend(p.grad.detach().cpu() for p in system.net.parameters())
                update()
            state.optimizer.step = recording_update
            metrics = {k: float(v) for k, v in step(b).items()}
            refs[tag] = dict(metrics=metrics, grads=grads,
                             params=[p.detach().cpu() for p in single.net.parameters()],
                             buffers=[x.cpu() for x in single.net.buffers()])
        lr = state.optimizer.schedule(0)
        del single, state, step
        logs = [p.communicate(timeout=600)[0] for p in procs]
        check(all(p.returncode == 0 for p in procs),
              'ddp_stereo_train: a rank failed:\n' + '\n'.join(log[-3000:] for log in logs))
        ranks = [torch.load(path) for path in outs]
    wall = time.perf_counter() - t0
    ref, flo = refs['single'], refs['flipped']
    result = {}
    for r, out in enumerate(ranks):
        loss_err = {k: abs(out['metrics'][k] - v) / max(abs(v), 1e-30)
                    for k, v in ref['metrics'].items()}
        loss_floor = {k: abs(flo['metrics'][k] - v) / max(abs(v), 1e-30)
                      for k, v in ref['metrics'].items()}
        bad = {k: (loss_err[k], loss_floor[k]) for k in loss_err
               if loss_err[k] > max(8 * loss_floor[k], 2e-4)}
        worst = max(float((a - b).abs().max()) for a, b in zip(out['grads'], ref['grads']))
        floor = max(float((a - b).abs().max()) for a, b in zip(flo['grads'], ref['grads']))
        gmax = max(float(b.abs().max()) for b in ref['grads'])
        den = sum(float(b.double().norm()) ** 2 for b in ref['grads'])
        rel = (sum(float((a - b).double().norm()) ** 2
                   for a, b in zip(out['grads'], ref['grads'])) / den) ** 0.5
        rel_floor = (sum(float((a - b).double().norm()) ** 2
                         for a, b in zip(flo['grads'], ref['grads'])) / den) ** 0.5
        param_err = max(float((a - b).abs().max()) for a, b in zip(out['params'], ref['params']))
        stats = [(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)),
                  float((f - b).abs().max() / b.abs().max().clamp_min(1e-30)))
                 for a, b, f in zip(out['buffers'], ref['buffers'], flo['buffers'])
                 if b.is_floating_point()]
        stats_err, stats_floor = max(s[0] for s in stats), max(s[1] for s in stats)
        result[f'rank{r}'] = dict(
            loss_rel_err=loss_err, loss_rel_err_floor=loss_floor, grad_max_abs_err=worst,
            grad_max_abs_err_floor=floor, grad_max=gmax, grad_rel_err_all=rel,
            grad_rel_err_all_floor=rel_floor, param_max_abs_err=param_err,
            running_stats_rel_err=stats_err, running_stats_rel_err_floor=stats_floor,
            launches=out['launches'], updates=out['count'])
        check(not bad, f'ddp_stereo_train rank {r}: loss terms differ beyond the floor {bad}')
        check(worst <= max(8 * floor, 1e-5 * gmax) and worst <= 5e-2 * gmax
              and rel <= max(3 * rel_floor, 1e-6),
              f'ddp_stereo_train rank {r}: gradients differ: max abs {worst} (floor {floor}, gmax '
              f'{gmax}), norm-wise {rel} (floor {rel_floor})')
        check(param_err <= 2.5 * lr, f'ddp_stereo_train rank {r}: parameters differ by '
                                     f'{param_err} (lr {lr})')
        check(stats_err <= max(3 * stats_floor, 1e-4),
              f'ddp_stereo_train rank {r}: running statistics differ by {stats_err} (floor '
              f'{stats_floor})')
        check(out['count'] == 1 and out['launches']['correlation_volume_interleaved'] == 2
              and out['launches']['correlation_backward_interleaved'] == 2,
              f'ddp_stereo_train rank {r}: {out["count"]} updates, launches {out["launches"]}')
    same = all(torch.equal(a, b) for a, b in zip(ranks[0]['params'], ranks[1]['params']))
    check(same, 'ddp_stereo_train: the ranks hold different parameters after the step')
    emit('ddp_stereo_train', world=DDP_WORLD, backend='gloo', batch=DDP_BATCH,
         per_rank=DDP_BATCH // DDP_WORLD, compute_dtype='bfloat16', lr=lr, wall_s=wall,
         total_single=ref['metrics']['total'], ranks_equal=same, **result)
    torch.cuda.empty_cache()
    return result


def cli_train_nccl_world1_phase(torch, km3d_config):
    """The train CLI (in this process) on the KM3D smoke config for one
    epoch of 2 steps at batch 16, plain and with ``--coordinator
    127.0.0.1:<port> --num_processes 1 --process_id 0``: NCCL on the card,
    every loss reduction and BatchNorm on the process group's path (the
    global statistics of SyncBatchNorm, the fast variance). numpy's
    generator is seeded before each run and the loader runs without
    threads, so every run sees the same augmented items. Self-calibrated,
    as ``km3d_train_parity``: the floor is a third, plain run whose images
    are moved by up to two f32 ulps on the card (two steps of Adam carry a
    last-bit change into every parameter that a near-zero gradient moves by
    about lr). Gates: the last step's loss within max(8x the floor's
    difference, 1e-4) relative; the parameters within max(3x the floor's
    largest difference, 2.5 * lr); the running statistics within max(3x the
    floor's, 1e-4) of their largest value."""
    import contextlib
    import io
    from visualdet3d_tpu_torch import checkpoint
    from visualdet3d_tpu_torch.cli import train as train_cli
    from visualdet3d_tpu_torch.config import cfg_from_file
    runs = {}
    real_device_batch = train_cli.device_batch
    gen = torch.Generator(device='cuda').manual_seed(73)

    def moved_device_batch(batch, device):
        out = real_device_batch(batch, device)
        u = torch.rand(out['images'].shape, generator=gen, device=device)
        out['images'] = out['images'] * (1 + 2.0 ** -22 * (2 * u - 1))
        return out

    for tag in ('plain', 'nccl', 'moved'):
        config = f'{km3d_config[:-3]}_{tag}.py'
        with open(km3d_config) as f, open(config, 'w') as g:
            g.write(f.read() + f"cfg.path.checkpoint_path = os.path.join(out, '{tag}_ckpt')\n"
                               f"cfg.path.log_path = os.path.join(out, '{tag}_log')\n"
                               'cfg.trainer.max_epochs = 1\ncfg.data.num_workers = 0\n')
        argv = ['--config', config]
        if tag == 'nccl':
            with __import__('socket').socket() as s:
                s.bind(('127.0.0.1', 0))
                port = s.getsockname()[1]
            argv += ['--coordinator', f'127.0.0.1:{port}', '--num_processes', '1',
                     '--process_id', '0']
        cfg = cfg_from_file(config)
        np.random.seed(0)
        buf = io.StringIO()
        train_cli.device_batch = moved_device_batch if tag == 'moved' else real_device_batch
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(argv)
        finally:
            train_cli.device_batch = real_device_batch
        wall = time.perf_counter() - t0
        with open(os.path.join(cfg.path.log_path, 'train_stats.jsonl')) as f:
            [stats] = [json.loads(line) for line in f]
        saved = checkpoint.CheckpointManager(cfg.path.checkpoint_path).restore()
        runs[tag] = dict(wall=wall, stats=stats, model=saved['model'], out=buf.getvalue(),
                         lr=cfg.optimizer.keywords.lr)
    plain = runs['plain']
    check('process 0 of 1' in runs['nccl']['out'], 'cli_train_nccl_world1: no process group')
    lr = plain['lr']
    steps = [r['stats']['steps'] for r in runs.values()]
    check(steps == [2, 2, 2], f'cli_train_nccl_world1: steps {steps}')

    def distance(other):
        loss = abs(other['stats']['loss'] - plain['stats']['loss']) / abs(plain['stats']['loss'])
        params = max(float((other['model'][k] - v).abs().max())
                     for k, v in plain['model'].items()
                     if v.is_floating_point() and 'running' not in k)
        stats = max(float((other['model'][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                    for k, v in plain['model'].items() if 'running' in k)
        return dict(loss_rel_err=loss, param_max_abs_err=params, running_stats_rel_err=stats)

    got, floor = distance(runs['nccl']), distance(runs['moved'])
    emit('cli_train_nccl_world1', backend='nccl', world=1, steps=2, lr=lr,
         wall_s={k: r['wall'] for k, r in runs.items()},
         step_ms={k: r['stats']['step_ms'] for k, r in runs.items()},
         last_loss={k: r['stats']['loss'] for k, r in runs.items()},
         nccl_vs_plain=got, moved_vs_plain=floor, launches_nccl=runs['nccl']['stats']['launches'])
    check(np.isfinite(plain['stats']['loss'])
          and got['loss_rel_err'] <= max(8 * floor['loss_rel_err'], 1e-4)
          and got['param_max_abs_err'] <= max(3 * floor['param_max_abs_err'], 2.5 * lr)
          and got['running_stats_rel_err'] <= max(3 * floor['running_stats_rel_err'], 1e-4),
          f'cli_train_nccl_world1: the NCCL run {got} against the floor {floor}')


def cli_quantize_eval_mono_int8_phase(torch, work, root, split):
    """``configs/yolo3d_gac.py`` in int8 (``detector.inference_dtype =
    'int8'``, post-optimisation off) on the tree: the imdb precompute,
    synthetic priors, a seeded checkpoint made ready to predict on the
    validation frames (as ``cli_eval_gac_postopt``); ``python -m
    visualdet3d_tpu_torch.cli.quantize`` (a subprocess) writes the int8
    artifact; then the eval CLI with ``--quantized_path`` and calibrating on
    the fly, each on the repeated frames of ``timed_eval_config``: their
    result files equal, with detections; B8 and the quantize launch every
    frame."""
    from visualdet3d_tpu_torch import checkpoint, testing
    from visualdet3d_tpu_torch.cli import eval as eval_cli
    from visualdet3d_tpu_torch.cli import imdb_precompute_3d
    from visualdet3d_tpu_torch.config import cfg_from_file
    from visualdet3d_tpu_torch.registry import DETECTOR_DICT
    import visualdet3d_tpu_torch.models  # noqa: F401
    config = smoke_config(work, 'yolo3d_gac.py', 'gac_int8', root, split, 1)
    with open(config, 'a') as f:
        f.write("cfg.detector.inference_dtype = 'int8'\n"
                'cfg.detector.head.test_cfg.post_optimization = False\n')
    cfg = cfg_from_file(config)
    imdb_precompute_3d.run(cfg)
    testing.write_synthetic_priors(cfg.path.preprocessed_path, cfg.obj_types, num_ratios=2)
    cfg.detector.inference_dtype = 'float32'  # the checkpoint is the f32 network's
    system = DETECTOR_DICT[cfg.detector.name](cfg.detector, device='cuda')
    val = eval_cli.dataset_of(cfg, 'validation')
    batch = val.collate_fn([val[i] for i in range(len(val))])
    images = torch.as_tensor(batch['images'], device='cuda')
    P2 = torch.as_tensor(batch['P2'], device='cuda')
    testing.prepare_mono_for_predict(system, images, P2, torch.Generator().manual_seed(46))
    with torch.no_grad():
        cls = system.predict_raw(images, P2)[0][..., 0].float()
        useful = system.anchors.useful_mask(system.anchor_pack(tuple(images.shape[1:3])), P2)
        system.prediction_convs()[0].bias += 1.5 - torch.quantile(cls[useful], 0.995)
    ckpt = os.path.join(work, 'gac_int8_checkpoint')
    checkpoint.CheckpointManager(ckpt).save(0, {'model': system.net.state_dict()})
    del system, images, P2
    torch.cuda.empty_cache()
    timed = timed_eval_config(config)
    artifact = os.path.join(work, 'gac_int8.pt')
    cmd = [sys.executable, '-m', 'visualdet3d_tpu_torch.cli.quantize', '--config', timed,
           '--checkpoint_path', ckpt, '--output_path', artifact]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    quantize_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'cli.quantize (GAC int8) failed (rc {proc.returncode}):\n'
                                f'{proc.stderr[-3000:]}')
    runs = {}
    for name, path in (('artifact', artifact), ('on_the_fly', None)):
        t0 = time.perf_counter()
        stats, out, files, launches = run_eval_cli(torch, timed, ckpt,
                                                   f'cli_quantize_eval_mono_int8 {name}',
                                                   quantized_path=path)
        runs[name] = dict(process_s=time.perf_counter() - t0, files=files,
                          **eval_summary(stats, files, ap_table(out), stats['launches']),
                          launches_in_cli_run={k: v for k, v in launches.items() if v})
    check(runs['artifact']['files'] == runs['on_the_fly']['files'],
          'cli_quantize_eval_mono_int8: the artifact and the on-the-fly calibration wrote '
          'different results')
    check(any(runs['artifact']['files'].values()), 'cli_quantize_eval_mono_int8: no detection')
    for name, r in runs.items():
        per = r['launches_per_frame']
        check(per.get('int8_conv2d', 0) > 0 and per.get('int8_quantize') == per.get('int8_conv2d'),
              f'cli_quantize_eval_mono_int8 {name}: launches a frame {per}')
        del r['files']
    emit('cli_quantize_eval_mono_int8', config='configs/yolo3d_gac.py',
         quantize_process_s=quantize_s, results_equal=True, **runs)
    return runs


def int8_mono_ddp_tree_phases(torch, work, configs):
    """The int8 mono and process-group phases on the KITTI object tree: the
    GAC int8 quantize and eval CLIs (on the stereo config's split, as
    ``cli_eval_gac_postopt``), then the train CLI over NCCL at world 1."""
    from visualdet3d_tpu_torch.config import cfg_from_file
    t0 = time.perf_counter()
    stereo_cfg = cfg_from_file(configs['stereo'])
    root = stereo_cfg.path.data_path
    split = (stereo_cfg.data.train_split_file, stereo_cfg.data.val_split_file)
    mono_int8 = cli_quantize_eval_mono_int8_phase(torch, work, root, split)
    cli_train_nccl_world1_phase(torch, configs['km3d'])
    emit('int8_mono_ddp_tree_phases', seconds=time.perf_counter() - t0)
    return mono_int8


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke run needs a CUDA card')
    try:
        from visualdet3d_tpu_torch.entry import IMAGE_HW, build_system
        from visualdet3d_tpu_torch.ops import cost_volume as cv
        from visualdet3d_tpu_torch.ops import deform_conv as dc
        from visualdet3d_tpu_torch.ops import int8_block as ib
        from visualdet3d_tpu_torch.ops import int8_conv as ic
        from visualdet3d_tpu_torch.ops import kernel_build
        from visualdet3d_tpu_torch.entry import build_int8_system
        from visualdet3d_tpu_torch.testing import calibrate_prediction_convs
    except ImportError as e:
        fail(f'cannot import the port ({e}); run from the root of the repository')
    # f32 parity and f32 timings are full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(name)
    t0 = time.perf_counter()
    libs = kernel_build.build(['correlation', 'deform_conv', 'int8_conv', 'int8_block'])
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for so in libs.values()
             for line in so.with_name(so.name + '.log').read_text().splitlines()
             if 'registers' in line or 'spill' in line]
    emit('device', nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, peaks_of=part,
         peak_bytes_per_s=peaks[0], peak_f32_flops=peaks[1], peak_bf16_flops=peaks[2],
         kernel_build_s=build_s, ptxas=ptxas)

    kernels = kernel_phase(torch, cv, peaks)
    edge_case_phase(torch, cv)

    system = build_system(depth=34, device='cuda')
    gen = torch.Generator().manual_seed(5)
    calib = [torch.randn((4, *IMAGE_HW, 3), generator=gen).cuda() for _ in range(2)]
    calibrate_prediction_convs(system, (calib[0], calib[1]), gen)

    slices = {}
    for dtype_name in ('float32', 'bfloat16'):
        slices[dtype_name], batch, P2 = slice_phase(torch, cv, system, dtype_name)
        profile_phase(torch, system, batch, P2, dtype_name)
        del batch
    parity_phase(torch, system)
    del system
    torch.cuda.empty_cache()

    corr_bwd = corr_bwd_kernel_phase(torch, cv, peaks)
    corr_bwd_edge_phase(torch, cv)
    stereo_trains = {name: stereo_train_phase(torch, cv, cd)
                     for name, cd in (('bfloat16', 'bfloat16'), ('float32', None))}
    stereo_train_parity_phase(torch)

    int8_conv_edge_phase(torch, ic)
    probe = int8_probe_phase(torch, ic, part)
    system = build_int8_system(device='cuda')
    int8_slices = {}
    for mode in ('int8', 'int8+K8', 'bfloat16'):
        int8_slices[mode], batch, P2 = int8_slice_phase(torch, cv, ic, ib, system, mode)
    shapes = int8_conv_shapes(torch, system, (*batch, P2))
    b8 = int8_conv_kernel_phase(torch, ic, shapes, part)
    b8_plan = int8_plan_phase(torch, ic, system, batch, P2)
    k8 = int8_block_kernel_phase(torch, ib, system, layer1_input(torch, system, batch, P2), part)
    int8_block_edge_phase(torch, ib, system)
    del system, batch
    torch.cuda.empty_cache()
    int8_parity_phase(torch)

    dcn = deform_kernel_phase(torch, dc, peaks)
    deform_edge_phase(torch, dc)
    alltaps = dcn_alltaps_kernel_phase(torch, dc, peaks)
    dcn_alltaps_edge_phase(torch, dc)
    premul = dcn_premul_kernel_phase(torch, dc, peaks)
    dcn_premul_edge_phase(torch, dc)
    slices_of = {}
    for model in ('km3d', 'monoflex'):
        system = build_km3d(torch, model)
        slices_of[model] = {}
        for dtype_name in ('float32', 'bfloat16'):
            slices_of[model][dtype_name], batch, P2 = km3d_slice_phase(
                torch, dc, system, dtype_name, phase=f'{model}_slice')
            km3d_profile_phase(torch, system, batch, P2, dtype_name, phase=f'{model}_profile')
            del batch
        km3d_parity_phase(torch, system, model)
        if model == 'km3d':
            variants = km3d_dcn_variants_phase(torch, dc, system)
            km3d_dcn_variants_parity_phase(torch, system)
        del system
        torch.cuda.empty_cache()
    km3d_slices = slices_of['km3d']

    dcn_bwd = deform_bwd_kernel_phase(torch, dc, peaks)
    deform_bwd_edge_phase(torch, dc)
    deform_module_grad_phase(torch)
    trains = {name: km3d_train_phase(torch, dc, cd)
              for name, cd in (('bfloat16', 'bfloat16'), ('float32', None))}
    km3d_train_parity_phase(torch)
    monoflex_trains = {name: km3d_train_phase(torch, dc, cd, 'monoflex', MONOFLEX_BATCH)
                       for name, cd in (('bfloat16', 'bfloat16'), ('float32', None))}
    gac_slices, gac_kernel, gac_trains = gac_phases(torch, dc, peaks)
    a6 = a6_phases(torch, dc, peaks)
    mono8 = int8_mono_phases(torch, dc, ic, part)
    ddp_stereo_train_phase(torch)
    cli_km3d, cli_stereo, eval_launches, a6_cli, mono8_cli = kitti_training_phases(torch)

    dtype_of = {'f32': 'float32', 'bf16': 'bfloat16'}
    replaces = {  # the TPU kernel bodies _corr_kernel_eyes and _corr_kernel
        'correlation_volume_interleaved': 'visualdet3d_tpu/ops/cost_volume.py:106',
        'correlation_volume': 'visualdet3d_tpu/ops/cost_volume.py:95',
    }
    summary = []
    for (kernel, dt), r in kernels.items():
        summary.append(dict(
            name=f'{kernel}[{dt}]', route='cuda',
            source='visualdet3d_tpu_torch/csrc/correlation.cu',
            replaces=replaces[kernel],
            launches=slices[dtype_of[dt]]['launches'][kernel],
            launches_in_training=stereo_trains[dtype_of[dt]]['launches'][kernel],
            launches_per_step_in_cli_training=(cli_stereo['launches_per_step'].get(kernel)
                                               if dt == 'f32' else None),
            launches_per_eval_frame=eval_launches[('stereo', dtype_of[dt])].get(kernel, 0),
            launches_per_int8_eval_frame=(eval_launches[('stereo', 'int8')].get(kernel, 0)
                                          if dt == 'bf16' else None),
            max_abs_err=r['max_abs_err'], ms=r['ms'], graph_ms=r['graph_ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            share_of_bound=r['share_of_bound'], share_of_bound_device=r['share_of_bound_device'],
            library_ms=None, bmm_ms=r['bmm_ms'],
            bmm='torch.bmm of every (pair, row), [W, C] x [C, W]: the whole L . R^T whose band '
                'the kernel keeps (not the same function)',
            per_forward='stride-4 + stride-8 calls, batch 16; ms in CUDA events, graph_ms in '
                        'device time', per_shape=r['per_shape']))
    for dt, r in corr_bwd.items():
        summary.append(dict(
            name=f'correlation_backward_interleaved[{dt}]', route='cuda',
            source='visualdet3d_tpu_torch/csrc/correlation.cu',
            replaces='visualdet3d_tpu/ops/cost_volume.py:270 (XLA vjp; no Pallas kernel)',
            launches=stereo_trains[dtype_of[dt]]['launches']['correlation_backward_interleaved'],
            launches_per_step_in_cli_training=(cli_stereo['launches_per_step'].get(
                'correlation_backward_interleaved') if dt == 'f32' else None),
            max_abs_err=r['max_abs_err'], ms=r['ms'], graph_ms=r['graph_ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            share_of_bound=r['share_of_bound'], share_of_bound_device=r['share_of_bound_device'],
            library_ms=None, bmm_ms=r['bmm_ms'],
            bmm='two torch.bmm of a dense [W, W] matrix by each eye [W, C], every (pair, row): '
                'the dense products whose band the kernel computes (not the same function)',
            per_step='the stride-4 + stride-8 backward of one training step at batch 16; ms '
                     'in CUDA events, graph_ms in device time; launches: 6 training steps ('
                     f'batch {STEREO_TRAIN_BATCH[dtype_of[dt]]})', per_shape=r['per_shape']))
    dcn_replaces = {  # the TPU kernel bodies _lerp_matmul_f32_kernel and _lerp_matmul_kernel
        'f32': 'visualdet3d_tpu/ops/deform_conv.py:363',
        'bf16': 'visualdet3d_tpu/ops/deform_conv.py:161',
    }
    for dt, r in dcn.items():
        summary.append(dict(
            name=f'modulated_deform_conv[{dt}]', route='cuda',
            source='visualdet3d_tpu_torch/csrc/deform_conv.cu', replaces=dcn_replaces[dt],
            launches=km3d_slices[dtype_of[dt]]['launches'],
            launches_monoflex=slices_of['monoflex'][dtype_of[dt]]['launches'],
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'], library_ms=None,
            dense_conv_ms=r['dense_conv_ms'],
            launches_in_training=trains[dtype_of[dt]]['launches']['modulated_deform_conv'],
            launches_per_step_in_cli_training=(cli_km3d['launches_per_step'].get(
                'modulated_deform_conv') if dt == 'f32' else None),
            launches_in_monoflex_training=monoflex_trains[dtype_of[dt]]['launches'][
                'modulated_deform_conv'],
            launches_per_eval_frame=eval_launches[('km3d', dtype_of[dt])].get(
                'modulated_deform_conv', 0),
            per_forward='the 16 DCNs of one KM3D forward, batch 16 (shapes weighted by count)',
            launches_in_mono_int8_predicts=(
                {MONO_INT8_MODELS[m]: s['int8']['launches']['modulated_deform_conv']
                 for m, s in mono8['slices'].items()} if dt == 'bf16' else None),
            per_shape=r['per_shape']))
    summary.append(dict(  # the TPU kernel body _lerp_matmul_alltaps_kernel
        name='modulated_deform_conv_alltaps[bf16]', route='cuda',
        source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
        replaces='visualdet3d_tpu/ops/deform_conv.py:255',
        launches=variants['alltaps']['launches']['modulated_deform_conv_alltaps'],
        launches_under_both_switches=variants['both']['launches'][
            'modulated_deform_conv_alltaps'],
        launches_in_one_monoflex_step=monoflex_trains['bfloat16'][
            'launches_of_one_alltaps_step']['modulated_deform_conv_alltaps'],
        max_abs_err=alltaps['max_abs_err'], ms=alltaps['ms'], plain_ms=alltaps['plain_ms'],
        bound_ms=alltaps['bound_ms'], bound_by=alltaps['bound_by'], library_ms=None,
        b4_ms=alltaps['b4_ms'], max_abs_diff_b4=alltaps['max_abs_diff_b4'],
        bitwise_equal_b4=alltaps['bitwise_equal_b4'],
        per_forward='the 16 DCNs of one KM3D forward, batch 16 (shapes weighted by count); '
                    'launches: 6 KM3D bf16 predicts under VD3D_DCN_ALLTAPS=1',
        per_shape=alltaps['per_shape'],
        launches_in_one_monodepth_bf16_step=a6['monodepth_train']['bfloat16'][
            'launches_of_one_alltaps_step']['modulated_deform_conv_alltaps'],
        monodepth=dict(a6['dcn']['per_forward']['alltaps'],
                       per_forward='the three U-Net DCNs of one MonoDepth forward, batch 8, '
                                   '352x1216')))
    summary.append(dict(  # the TPU kernel body _lerp_accum_kernel
        name='modulated_deform_conv_premul_accum[bf16]', route='cuda',
        source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
        replaces='visualdet3d_tpu/ops/deform_conv.py:418',
        launches=variants['premul']['launches']['modulated_deform_conv_premul_accum'],
        launches_under_both_switches=variants['both']['launches'][
            'modulated_deform_conv_premul_accum'],
        max_abs_err=0.0, ms=premul['ms'], graph_ms=premul['graph_ms'],
        plain_ms=premul['plain_ms'], bound_ms=premul['bound_ms'], bound_by=premul['bound_by'],
        share_of_bound=premul['share_of_bound'],
        share_of_bound_device=premul['share_of_bound_device'], library_ms=None,
        table_matmul_ms=premul['table_ms'], table_bound_ms=premul['table_bound_ms'],
        premul_op_ms=premul['op_ms'], premul_op_plain_ms=premul['op_plain_ms'],
        premul_op_max_abs_err=premul['max_abs_err'], b4_ms_same_shapes=premul['b4_ms'],
        per_forward='the 8 proj DCNs of one KM3D forward, batch 16 (shapes weighted by '
                    'count), given the table; ms in CUDA events, graph_ms in device time; '
                    'launches: 6 KM3D bf16 predicts under VD3D_DCN_PREMUL=1',
        per_shape=premul['per_shape'],
        monodepth=dict(a6['dcn']['per_forward']['premul'],
                       per_forward='up0 and up1 of MonoDepth, batch 8, given the table; not on '
                                   "MonoDepth's path: its bf16 inference runs the decoder in "
                                   'f32, and training takes no premul')))
    for dt, r in dcn_bwd.items():  # the TPU kernel body _lerp_matmul_bwd_kernel (bf16)
        step_launches = trains[dtype_of[dt]]['launches']
        mono_launches = monoflex_trains[dtype_of[dt]]['launches']
        common = dict(route='cuda', source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
                      replaces='visualdet3d_tpu/ops/deform_conv.py:663', library_ms=None,
                      plain_ms=r['plain_ms'], plain='the whole plain backward (autograd through '
                      'the plain forward), per step', backward_ms_events=r['ms'],
                      backward_bound_ms=r['bound_ms'], dx_adds_per_step=r['dx_adds'])
        summary.append(dict(
            name=f'modulated_deform_conv_backward_input[{dt}]',
            launches=step_launches['modulated_deform_conv_backward_input'],
            launches_in_monoflex_training=mono_launches['modulated_deform_conv_backward_input'],
            launches_per_step_in_cli_training=(cli_km3d['launches_per_step'].get(
                'modulated_deform_conv_backward_input') if dt == 'f32' else None),
            max_abs_err=r['max_abs_err_dx'], ms=r['dx_ms'], bound_ms=r['dx_bound_ms'],
            bound_by=r['dx_bound_by'], **common,
            per_forward='the dx kernel of the 16 DCNs of one KM3D training step, batch 16 '
                        '(shapes weighted by count), device time'))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_weight[{dt}]',
            launches=step_launches['modulated_deform_conv_backward_weight'],
            launches_of_reduce=step_launches['modulated_deform_conv_backward_weight_reduce'],
            launches_in_monoflex_training=mono_launches['modulated_deform_conv_backward_weight'],
            launches_per_step_in_cli_training=(cli_km3d['launches_per_step'].get(
                'modulated_deform_conv_backward_weight') if dt == 'f32' else None),
            max_abs_err=r['max_abs_err_dw'], ms=r['dw_ms'], reduce_ms=r['dw_reduce_ms'],
            bound_ms=r['dw_bound_ms'], bound_by=r['dw_bound_by'], **common,
            per_forward='the dW kernels (split sums and their reduce) of the 16 DCNs of one '
                        'KM3D training step, batch 16 (shapes weighted by count), device time',
            per_shape=r['per_shape']))
    for dt, r in gac_kernel.items():  # the head DCN of Yolo3D: K3/K5 forward, K7 backward
        yolo3d_slice = gac_slices['dcn'][dtype_of[dt]]
        yolo3d_train = gac_trains['dcn'][dtype_of[dt]]['launches']
        common = dict(route='cuda', source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
                      library_ms=None, shape='[16, 18, 80, 1024] -> 1024, the Yolo3D head DCN '
                      'at stride 16 of 288x1280, batch 16; plain versions at batch 16')
        summary.append(dict(
            name=f'modulated_deform_conv[{dt}, gac_head]', replaces=dcn_replaces[dt],
            launches=yolo3d_slice['launches'],
            launches_in_training=yolo3d_train['modulated_deform_conv'],
            max_abs_err=r['max_abs_err'], ms=r['ms'], device_ms=r['device_ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            dense_conv_ms=r['dense_conv_ms'],
            per_forward='one call; launches: 6 Yolo3D batch-16 predicts (and 6 training steps '
                        'at batch 8)', **common))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_input[{dt}, gac_head]',
            replaces='visualdet3d_tpu/ops/deform_conv.py:663',
            launches=yolo3d_train['modulated_deform_conv_backward_input'],
            max_abs_err=r['max_abs_err_dx'], ms=r['dx_ms'], plain_ms=r['backward_plain_ms'],
            plain='the whole plain backward', bound_ms=r['dx_bound_ms'],
            bound_by=r['dx_bound_by'], backward_ms_events=r['backward_ms_events'],
            dx_f32_plan=r.get('dx_tile_dy_resident_smem'), dx_adds=r['dx_adds'],
            per_forward='the dx kernel, one call, device time; launches: 6 Yolo3D training '
                        'steps at batch 8', **common))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_weight[{dt}, gac_head]',
            replaces='visualdet3d_tpu/ops/deform_conv.py:663',
            launches=yolo3d_train['modulated_deform_conv_backward_weight'],
            launches_of_reduce=yolo3d_train['modulated_deform_conv_backward_weight_reduce'],
            max_abs_err=r['max_abs_err_dw'], ms=r['dw_ms'], reduce_ms=r['dw_reduce_ms'],
            plain_ms=r['backward_plain_ms'], plain='the whole plain backward',
            bound_ms=r['dw_bound_ms'], bound_by=r['dw_bound_by'], dw_splits=r['dw_splits'],
            per_forward='the dW kernels (split sums and their reduce), one call, device time; '
                        'launches: 6 Yolo3D training steps at batch 8', **common))
    md = a6['dcn']
    md_predict = sum(a6['monodepth_slice'][d]['launches'] for d in ('float32', 'bfloat16'))
    for dt in ('f32', 'bf16'):  # the U-Net's DCNs: K5/K3 forward, K7 backward
        pf = md['per_forward'][dt]
        step = a6['monodepth_train']['bfloat16' if dt == 'bf16' else 'float32']['launches']
        cli = a6_cli['launches_per_step'] if dt == 'f32' else {}
        shapes = {name: {k: r[k] for k in ('x', 'c_out', 'ms', 'device_ms', 'plain_ms',
                                             'dense_conv_ms', 'bound_ms', 'bound_by', 'dx_ms',
                                             'dw_ms', 'dx_bound_ms', 'dw_bound_ms')}
                  for name, r in md[dt].items()}
        common = dict(route='cuda', source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
                      library_ms=None)
        summary.append(dict(
            name=f'modulated_deform_conv[{dt}, monodepth]', replaces=dcn_replaces[dt],
            launches=md_predict if dt == 'f32' else step['modulated_deform_conv'],
            launches_in_predict=md_predict if dt == 'f32' else 0,
            launches_in_training=step['modulated_deform_conv'],
            launches_per_step_in_cli_training=cli.get('modulated_deform_conv'),
            launches_per_eval_frame=(a6_cli['eval_launches_per_frame'] if dt == 'f32' else 0),
            max_abs_err=pf['max_abs_err'], ms=pf['ms'], device_ms=pf['device_ms'],
            plain_ms=pf['plain_ms'], bound_ms=pf['bound_ms'], bound_by=pf['bound_by'],
            dense_conv_ms=pf['dense_conv_ms'], per_shape=shapes,
            per_forward='the three U-Net DCNs of one MonoDepth forward, batch 8, 352x1216; '
                        'launches: f32 = 6 predicts in f32 and 6 in bf16 (the decoder runs f32), '
                        'bf16 = 6 bf16 training steps', **common))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_input[{dt}, monodepth]',
            replaces='visualdet3d_tpu/ops/deform_conv.py:663',
            launches=step['modulated_deform_conv_backward_input'],
            launches_per_step_in_cli_training=cli.get('modulated_deform_conv_backward_input'),
            max_abs_err=pf['max_abs_err_dx'], ms=pf['dx_ms'], plain_ms=pf['backward_plain_ms'],
            plain='the whole plain backward', bound_ms=pf['dx_bound_ms'],
            bound_by=pf['dx_bound_by'], backward_ms_events=pf['backward_ms_events'],
            per_forward='the dx kernel of the three U-Net DCNs, batch 8, device time; '
                        'launches: 6 training steps', **common))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_weight[{dt}, monodepth]',
            replaces='visualdet3d_tpu/ops/deform_conv.py:663',
            launches=step['modulated_deform_conv_backward_weight'],
            launches_of_reduce=step['modulated_deform_conv_backward_weight_reduce'],
            launches_per_step_in_cli_training=cli.get('modulated_deform_conv_backward_weight'),
            max_abs_err=pf['max_abs_err_dw'], ms=pf['dw_ms'], reduce_ms=pf['dw_reduce_ms'],
            plain_ms=pf['backward_plain_ms'], plain='the whole plain backward',
            bound_ms=pf['dw_bound_ms'], bound_by=pf['dw_bound_by'],
            dw_splits={name: r['dw_splits'] for name, r in md[dt].items()},
            per_forward='the dW kernels (split sums and their reduce) of the three U-Net DCNs, '
                        'batch 8, device time; launches: 6 training steps', **common))
    summary.append(dict(
        name='int8_conv2d', route='cuda', source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
        replaces='visualdet3d_tpu/models/quant.py:295 (XLA s8 conv_general_dilated; no Pallas '
                 'kernel)',
        launches=int8_slices['int8']['launches']['int8_conv2d'],
        launches_with_fused_blocks=int8_slices['int8+K8']['launches']['int8_conv2d'],
        max_abs_err=b8['max_abs_err'], ms=b8['ms'], plain_ms=b8['plain_ms'],
        bound_ms=b8['bound_ms'], bound_by=b8['bound_by'], library_ms=b8['library_ms'],
        library='cuDNN bf16 conv of the same shapes (not the same function)',
        launches_by_path={k: int8_slices['int8']['launches'][f'int8_conv2d_{k}']
                          for k in ('wgmma', 'wgmma_splitk', 'cp_async')},
        launches_per_eval_frame=eval_launches[('stereo', 'int8')].get('int8_conv2d', 0),
        launches_per_mono_int8_predict={
            MONO_INT8_MODELS[m]: r['int8']['launches_per_predict']['int8_conv2d']
            for m, r in mono8['slices'].items()},
        launches_per_gac_int8_eval_frame=mono8_cli['artifact']['launches_per_frame'].get(
            'int8_conv2d', 0),
        int8_predict_by_plan_variant=b8_plan['predict'],
        per_forward='every quantized conv of one batch-16 int8 predict, bf16 out '
                    '(shapes weighted by count)', per_shape=b8['per_shape']))
    summary.append(dict(
        name='int8_quantize', route='cuda', source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
        replaces='visualdet3d_tpu/models/quant.py:396 (XLA elementwise _quantize_act; no Pallas '
                 'kernel)',
        launches=int8_slices['int8']['launches']['int8_quantize'],
        launches_with_fused_blocks=int8_slices['int8+K8']['launches']['int8_quantize'],
        launches_per_eval_frame=eval_launches[('stereo', 'int8')].get('int8_quantize', 0),
        launches_per_mono_int8_predict={
            MONO_INT8_MODELS[m]: r['int8']['launches_per_predict']['int8_quantize']
            for m, r in mono8['slices'].items()},
        max_abs_err=0.0, ms=b8['quantize']['ms'], graph_ms=b8['quantize']['graph_ms'],
        plain_ms=b8['quantize']['plain_ms'], bound_ms=b8['quantize']['bound_ms'],
        bound_by='bytes', library_ms=b8['quantize']['library_ms'],
        library='torch.quantize_per_tensor on an f32 copy, device time (not the same '
                'function: it divides and clips at -128)',
        per_forward='the input of every quantized conv of one batch-16 int8 predict, bf16 in; '
                    'ms in CUDA events, graph_ms in device time',
        per_shape=b8['quantize']['per_shape']))
    summary.append(dict(
        name='int8_conv2d[K9 probes]', route='cuda',
        source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
        replaces='tools/probe_pallas_int8.py:34 (and :56, :85)',
        launches=int8_slices['int8']['launches']['int8_conv2d'],
        max_abs_err=0.0, ms=probe['ms'], plain_ms=probe['plain_ms'], bound_ms=probe['bound_ms'],
        bound_by=probe['bound_by'], library_ms=probe['int_mm_ms'], library='torch._int_mm',
        probe_ms=probe['probe_ms'], gops=probe['gops'], graph_ms=probe['graph_ms'],
        int_mm_graph_ms=probe['int_mm_graph_ms'],
        per_forward='(a) [2560, 576] x [576, 64] s8 -> s32; launches: the same kernel on the '
                    'int8 path'))
    summary.append(dict(
        name='int8_basic_block', route='cuda', source='visualdet3d_tpu_torch/csrc/int8_block.cu',
        replaces='visualdet3d_tpu/ops/int8_block.py:54',
        launches=int8_slices['int8+K8']['launches']['int8_basic_block'],
        max_abs_err=k8['max_abs_err'], ms=k8['ms'], graph_ms=k8['graph_ms'],
        f32_out_graph_ms=k8['f32_out_graph_ms'], plain_ms=k8['plain_ms'],
        bound_ms=k8['bound_ms'], bound_by=k8['bound_by'], library_ms=None,
        cudnn_bf16_two_convs_ms=k8['cudnn_bf16_two_convs_ms'],
        per_forward='one layer1 block at batch 16 (32 x 72 x 320 x 64), bf16 out; ms in CUDA '
                    'events, graph_ms in device time'))
    for model, t in mono8['totals'].items():  # B8 and the quantize at the mono shapes
        tag = MONO_INT8_MODELS[model]
        launches = mono8['slices'][model]['int8']['launches']
        summary.append(dict(
            name=f'int8_conv2d[{tag}]', route='cuda',
            source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
            replaces='visualdet3d_tpu/models/quant.py:295 (XLA s8 conv_general_dilated; no '
                     'Pallas kernel)',
            launches=launches['int8_conv2d'],
            launches_by_path={k: launches[f'int8_conv2d_{k}']
                              for k in ('wgmma', 'wgmma_splitk', 'cp_async')},
            max_abs_err=t['max_abs_err'], ms=t['ms'], device_ms=t['device_ms'],
            plain_ms=t['plain_ms'], bound_ms=t['bound_ms'], bound_by=t['bound_by'],
            library_ms=t['library_ms'],
            library='cuDNN bf16 conv of the same shapes (not the same function)',
            plans_by_path=t['by_path'], shapes=t['shapes'],
            per_forward=f'every quantized conv of one batch-16 {tag} int8 predict, bf16 out '
                        '(shapes weighted by count); ms in CUDA events, device_ms from CUDA '
                        f'graphs; launches: {N_BATCHES} predicts'))
        summary.append(dict(
            name=f'int8_quantize[{tag}]', route='cuda',
            source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
            replaces='visualdet3d_tpu/models/quant.py:396 (XLA elementwise _quantize_act; no '
                     'Pallas kernel)',
            launches=launches['int8_quantize'], max_abs_err=0.0, ms=t['quantize_ms'],
            device_ms=t['quantize_device_ms'], plain_ms=t['quantize_plain_ms'],
            bound_ms=t['quantize_bound_ms'], bound_by='bytes', library_ms=None,
            per_forward=f'the input of every quantized conv of one batch-16 {tag} int8 '
                        f'predict; launches: {N_BATCHES} predicts'))
    emit('wall', total_s=time.perf_counter() - t_start, kernel_build_s=build_s)
    print(json.dumps({'kernels': summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
