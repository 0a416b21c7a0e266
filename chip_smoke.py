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
2. kernel, kernel_edges: both correlation kernels against their plain
   PyTorch version at the stereo path's shapes (batch 16, 288x1280), f32
   and bf16, with their time (CUDA events, median over distinct inputs), the
   plain version's time and the least time the card could take
   (``bound_ms``), and ragged edge cases;
3. slice, profile, parity: ``Stereo3D.predict`` (ResNet-34 at 288x1280) at
   batch 16 in f32 and bf16 over distinct request batches: ms per batch,
   fps, batch-1 p50 latency, valid detections, the correlation launches
   over that run (set to 0 just before it); a ``torch.profiler`` breakdown
   of one batch-16 ``predict`` per dtype; batch-1 f32 (TF32 off) parity of
   the card against the same model on the CPU;
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
   shapes, with the times of the table, K6, the op and the per-tap kernel
   on the same shapes, and edge cases;
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
   mask, C_in 512, ragged tiles, stride 2, dilation 2, offsets of exactly
   +-R, +-(R - 0.5) and +-(R + 1) around the dx window on clipped tiles, an
   unaligned x) and the wrapper's refusals; deform_module_grad: the
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
   channel tails, +-127, and the wrappers' refusals); int8_probe (the int8
   probes K9a/b/c of ``tools/probe_pallas_int8.py`` at their shapes and
   seeds, bit-exact, beside ``torch._int_mm``, CUDA events and CUDA-graph
   device times); int8_slice in three modes (every conv on its own,
   layer1's blocks on the fused kernel K8, and the same folded network in
   bf16): ms per batch 16, fps, bs1 p50, peak memory, valid detections, the
   launches of B8 (per path), the quantize, K8 and K1 per predict, a
   profile; int8_conv_kernel (B8 at every conv shape of the batch-16
   predict, collected by hooks: its plan, s32 bit-exact, the f32 and bf16
   epilogues, its time against cuDNN's bf16 conv of the same shape and,
   at 1x1 stride-1 shapes, ``torch._int_mm``, the bound; the quantize
   kernel at each input); int8_plan, int8_plan_predict (B8's plan against
   its variants, split K, no split and the cp.async path, at K9(a) and at
   the batch-1 predict's shapes, bit-exact under each, event and device
   times, and the int8 predict at batch 1 and 16 under each);
   int8_block_kernel and int8_block_edges (K8 on the
   real layer1 entries and input at batch 16, and ragged tiles, against its
   plain version with the JAX package's block gate); int8_parity (the
   artifact quantized on the CPU, batch-1 int8 predict on the card against
   the CPU's, with the JAX package's decode gates).

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 16
N_BATCHES = 6     # distinct request batches per timed main-path run
N_KERNEL_RUNS = 10  # distinct inputs per kernel timing
N_BS1 = 12
MONOFLEX_BATCH = 8  # configs/monoflex.py's training batch

# (memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 dense FLOP/s),
# NVIDIA data sheets; the SXM part is the default
CARD_PEAKS = {
    'PCIe': (2.0e12, 51e12, 756e12),
    'SXM': (3.35e12, 67e12, 989e12),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


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
                'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'max_abs_err': 0.0,
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
                r = results[(kernel, dtype_name)]
                r['per_shape'][shape_name] = dict(
                    input=[2 * BATCH, h, w, c], num_disp=d, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms), max_abs_err=max_err,
                    achieved_gbps=n_bytes / (ms * 1e-3) / 1e9)
                r['ms'] += ms
                r['plain_ms'] += plain_ms
                r['bytes_bound_ms'] += bytes_ms
                r['ops_bound_ms'] += ops_ms
                r['max_abs_err'] = max(r['max_abs_err'], max_err)
                emit('kernel', kernel=kernel, dtype=dtype_name, shape=shape_name,
                     max_abs_err=max_err, tolerance=tol, ms=ms, plain_ms=plain_ms,
                     bound_ms=max(bytes_ms, ops_ms), bytes=n_bytes, flops=n_flops)
            del inputs, split, ref
    for r in results.values():
        r['bound_ms'] = max(r['bytes_bound_ms'], r['ops_bound_ms'])
        r['bound_by'] = 'bytes' if r['bytes_bound_ms'] >= r['ops_bound_ms'] else 'operations'
    return results


def edge_case_phase(torch, cv):
    """Ragged edges the main path does not reach: W not a multiple of the
    32-column tile and D > W; separate eyes and interleaved."""
    gen = torch.Generator(device='cuda').manual_seed(2)
    for b2, h, w, c, d in ((4, 3, 45, 16, 8), (2, 2, 5, 8, 12)):
        both = torch.randn((b2, h, w, c), generator=gen, device='cuda')
        ref = cv.correlation_volume_plain(both[0::2], both[1::2], d)
        for out in (cv.correlation_volume_interleaved(both, d),
                    cv.correlation_volume(both[0::2].contiguous(), both[1::2].contiguous(), d)):
            err = float((out - ref).abs().max())
            check(err <= 1e-5, f'edge case {(b2, h, w, c, d)}: max abs err {err}')
    emit('kernel_edges', ok=True, cases=['W=45 (ragged tile)', 'D=12 > W=5'])


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
    """Kernel time by name for one batch-16 predict, and the device's busy
    share of the wall time."""
    system.cfg.inference_dtype = dtype_name
    system.predict(*batch, P2)
    torch.cuda.synchronize()
    wall_ms, kernels, ops, device_ms = device_profile(torch, lambda: system.predict(*batch, P2))
    emit('profile', dtype=dtype_name, wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms, top_ops=top_events(ops, 12),
         top_kernels=top_events(kernels, 12))


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
    """K4 (all taps and every output channel of a pixel tile per block)
    against its plain version and against B4 at the 16 neck shapes, batch
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
    tot = dict(ms=0.0, table_ms=0.0, op_ms=0.0, b4_ms=0.0, plain_ms=0.0, op_plain_ms=0.0,
               bytes_ms=0.0,
               ops_ms=0.0, table_bound_ms=0.0, max_abs_err=0.0, min_share_2ulp=1.0,
               per_shape={})
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
        shape = dict(count=count, x=[BATCH, h, w, c_in], c_out=c_out, ms=ms, table_ms=table_ms,
                     op_ms=op_ms, b4_ms=b4_ms, plain_ms=plain_ms, op_plain_ms=op_plain_ms,
                     bound_ms=max(bytes_ms, ops_ms),
                     bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
                     table_bound_ms=table_bound, max_abs_err=err, share_within_2ulp=share,
                     lerp_accum_bitwise_equal_plain=True,
                     achieved_gbps=n_bytes / (ms * 1e-3) / 1e9)
        tot['per_shape'][f'{h}x{w} {c_in}->{c_out}'] = shape
        for key, v in (('ms', ms), ('table_ms', table_ms), ('op_ms', op_ms), ('b4_ms', b4_ms),
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
# 'kernel': the adds of the dx kernel that runs (the window design in bf16,
# the row design in f32)
DX_ADD_KEYS = ('kernel', 'global_adds', 'spilled', 'window', 'corner_adds', 'all_corners')


def dx_adds(torch, dc, dtype, offset, h, w, c_in):
    adds = dc.dx_window_spill(offset, h, w, c_in)
    adds['kernel'] = adds['global_adds' if dtype == torch.bfloat16 else 'corner_adds']
    return adds


# the backward's kernels by the prefix of their names in a profile: dx (the
# window kernel in bf16, the row kernel in f32), dW's split sums, their reduce
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
                         dx_adds={k: adds[k] for k in DX_ADD_KEYS}, dx_tile=adds['tile'],
                         dx_window=adds['window_hw'], max_abs_err=max_err, errors=errs,
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
    count, ragged channel tiles, stride 2, dilation 2, an unaligned x; and
    the wrapper's refusals."""
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
                 False)):
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


def km3d_parity_phase(torch, system, model='km3d'):
    """Batch 1, f32, TF32 off: the card's KM3D (or MonoFlex) against the
    same weights on the CPU. The same valid set and labels; 2D boxes, dimensions and alpha
    within rtol = atol = 1e-3 and the 3D centre within rtol 1e-2 (cuDNN and
    oneDNN sum the convs in different orders; the centre comes from a 3x3
    least-squares solve and a division by depth); raw maps within 1e-3 of
    their largest value."""
    from visualdet3d_tpu_torch import entry
    from visualdet3d_tpu_torch.entry import KITTI_P2, KM3D_IMAGE_HW
    system.cfg.inference_dtype = 'float32'
    cpu = getattr(entry, f'build_{model}_system')(device='cpu')
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
    # deform_conv_bwd_input_window_kernel (bf16) or deform_conv_bwd_input_kernel (f32)
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
    the CPU, same weights and batch (2 images at 384x1280; running
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
    batch = train_batches(torch, 1, 2, KM3D_IMAGE_HW, seed=25)[0]
    gpu, gpu_state, gpu_step = build_km3d_trainer(device='cuda', batch_size=2)
    prepare_km3d_for_training(gpu, batch['images'], torch.Generator().manual_seed(23),
                              offset_std=0.5, calibrate_head=False)
    init = {k: v.cpu() for k, v in gpu.net.state_dict().items()}
    cpu, cpu_state, cpu_step = build_km3d_trainer(device='cpu', batch_size=2)
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
    emit('km3d_train_parity', batch=2, image_hw=list(KM3D_IMAGE_HW), dtype='float32',
         tf32=False, loss_rel_err=loss_err, loss_rel_err_floor=loss_floor,
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
    activation of ``shape`` (NHWC), bit-exact; its time, the plain version's
    (torch's five elementwise passes) and the bytes bound (2 bytes read, 1
    written per element)."""
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
    return dict(ms=cuda_ms(lambda t: ic.quantize_act(t, inv), xs),
                plain_ms=cuda_ms(lambda t: ic.quantize_act_plain(t, inv), xs),
                bound_ms=3 * n / CARD_PEAKS[part][0] * 1e3)


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
    quant = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
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
        for key in ('ms', 'plain_ms', 'bound_ms'):
            quant[key] += count * q[key]
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
    emit('int8_quantize_per_forward', batch=BATCH, **quant)
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
    cases += ['quantize: per-channel scales, f32 and bf16, ragged sizes, saturation']

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
    """K8 against its plain version on the same inputs, f32 and bf16 out: the
    gate of the JAX package's block test, at most 0.1% of the elements beyond
    1e-4 of the output's scale and none beyond 0.02 of it (isolated int8
    levels of h can flip at round ties; the s32 sums themselves are exact)."""
    stats = {}
    for dt in (torch.float32, torch.bfloat16):
        got = ib.int8_basic_block(xq, w1, w2, params, dt).float()
        ref = ib.int8_basic_block_plain(xq, w1, w2, params, dt).float()
        torch.cuda.synchronize()
        scale = float(ref.abs().max()) or 1.0
        d = (got - ref).abs()
        frac = float((d > 1e-4 * scale).float().mean())
        check(frac <= 1e-3 and float(d.max()) <= 0.02 * scale,
              f'int8_basic_block {what} {dt}: {frac:.2e} of the elements beyond 1e-4 of the scale '
              f'{scale}, largest difference {float(d.max())}')
        stats[str(dt).split('.')[-1]] = dict(frac_beyond=frac, max_abs_err=float(d.max()),
                                             scale=scale, exact_share=float((d == 0).float().mean()))
    return stats


def int8_block_kernel_phase(torch, ib, system, layer1_input, part):
    """K8 at the main path's geometry (batch 16: 32 x 72 x 320 x 64) on the
    real layer1_0 entries and its real quantized input, against its plain
    version; its time, the plain version's, two cuDNN bf16 3x3 convs of the
    same shape (a yardstick, not the same function) and the bound."""
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
    ms = cuda_ms(lambda t: ib.int8_basic_block(t, w1, w2, params, torch.bfloat16), xs)
    plain_ms = cuda_ms(lambda t: ib.int8_basic_block_plain(t, w1, w2, params, torch.bfloat16),
                       xs[:3], warmup=1)
    xf = [t.permute(0, 3, 1, 2).to(torch.bfloat16) for t in xs]
    wf1, wf2 = (w.permute(0, 3, 1, 2).to(torch.bfloat16) for w in (w1, w2))
    cudnn_ms = cuda_ms(lambda t: F.conv2d(F.conv2d(t, wf1, padding=1), wf2, padding=1), xf)
    b, h, w, c = xq.shape
    ops = 2 * 2 * b * h * w * 9 * c * c
    nbytes = b * h * w * c + 2 * 9 * c * c + 6 * c * 4 + b * h * w * c * 2
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / int8_peak(part) * 1e3
    out = dict(shape=[b, h, w, c], ms=ms, plain_ms=plain_ms, cudnn_bf16_two_convs_ms=cudnn_ms,
               bound_ms=max(bytes_ms, ops_ms), bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
               bound_by='bytes' if bytes_ms >= ops_ms else 'operations', tops=ops / ms / 1e9,
               max_abs_err=stats['float32']['max_abs_err'], gate=stats)
    emit('int8_block_kernel', kernel='int8_basic_block', **out)
    return out


def int8_block_edge_phase(torch, ib, system):
    """K8 where tiles are ragged: H and W not multiples of the 8 x 32 tile,
    batch 1, W = 1, H = 1; and the wrapper's refusals."""
    be = block_entry(system)
    w1, w2 = be['e1']['kernel_q'], be['e2']['kernel_q']
    params = ib.block_params(be['e1'], be['e2'], be['bn1_scale'], be['bn1_shift'],
                             be['bn2_scale'], be['bn2_shift'])
    gen = torch.Generator(device='cuda').manual_seed(16)
    cases = [(2, 13, 45), (1, 72, 320), (1, 9, 1), (3, 1, 70), (1, 8, 32), (2, 17, 33)]
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


def main() -> int:
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
    calibrate_prediction_convs(system, calib[0], calib[1], gen)

    slices = {}
    for dtype_name in ('float32', 'bfloat16'):
        slices[dtype_name], batch, P2 = slice_phase(torch, cv, system, dtype_name)
        profile_phase(torch, system, batch, P2, dtype_name)
        del batch
    parity_phase(torch, system)
    del system
    torch.cuda.empty_cache()

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
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'], library_ms=None,
            per_forward='stride-4 + stride-8 calls, batch 16', per_shape=r['per_shape']))
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
            launches_in_monoflex_training=monoflex_trains[dtype_of[dt]]['launches'][
                'modulated_deform_conv'],
            per_forward='the 16 DCNs of one KM3D forward, batch 16 (shapes weighted by count)',
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
        per_shape=alltaps['per_shape']))
    summary.append(dict(  # the TPU kernel body _lerp_accum_kernel
        name='modulated_deform_conv_premul_accum[bf16]', route='cuda',
        source='visualdet3d_tpu_torch/csrc/deform_conv.cu',
        replaces='visualdet3d_tpu/ops/deform_conv.py:418',
        launches=variants['premul']['launches']['modulated_deform_conv_premul_accum'],
        launches_under_both_switches=variants['both']['launches'][
            'modulated_deform_conv_premul_accum'],
        max_abs_err=0.0, ms=premul['ms'], plain_ms=premul['plain_ms'],
        bound_ms=premul['bound_ms'], bound_by=premul['bound_by'], library_ms=None,
        table_matmul_ms=premul['table_ms'], table_bound_ms=premul['table_bound_ms'],
        premul_op_ms=premul['op_ms'], premul_op_plain_ms=premul['op_plain_ms'],
        premul_op_max_abs_err=premul['max_abs_err'], b4_ms_same_shapes=premul['b4_ms'],
        per_forward='the 8 proj DCNs of one KM3D forward, batch 16 (shapes weighted by '
                    'count), given the table; launches: 6 KM3D bf16 predicts under '
                    'VD3D_DCN_PREMUL=1',
        per_shape=premul['per_shape']))
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
            max_abs_err=r['max_abs_err_dx'], ms=r['dx_ms'], bound_ms=r['dx_bound_ms'],
            bound_by=r['dx_bound_by'], **common,
            per_forward='the dx kernel of the 16 DCNs of one KM3D training step, batch 16 '
                        '(shapes weighted by count), device time'))
        summary.append(dict(
            name=f'modulated_deform_conv_backward_weight[{dt}]',
            launches=step_launches['modulated_deform_conv_backward_weight'],
            launches_of_reduce=step_launches['modulated_deform_conv_backward_weight_reduce'],
            launches_in_monoflex_training=mono_launches['modulated_deform_conv_backward_weight'],
            max_abs_err=r['max_abs_err_dw'], ms=r['dw_ms'], reduce_ms=r['dw_reduce_ms'],
            bound_ms=r['dw_bound_ms'], bound_by=r['dw_bound_by'], **common,
            per_forward='the dW kernels (split sums and their reduce) of the 16 DCNs of one '
                        'KM3D training step, batch 16 (shapes weighted by count), device time',
            per_shape=r['per_shape']))
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
        int8_predict_by_plan_variant=b8_plan['predict'],
        per_forward='every quantized conv of one batch-16 int8 predict, bf16 out '
                    '(shapes weighted by count)', per_shape=b8['per_shape']))
    summary.append(dict(
        name='int8_quantize', route='cuda', source='visualdet3d_tpu_torch/csrc/int8_conv.cu',
        replaces='visualdet3d_tpu/models/quant.py:396 (XLA elementwise _quantize_act; no Pallas '
                 'kernel)',
        launches=int8_slices['int8']['launches']['int8_quantize'],
        max_abs_err=0.0, ms=b8['quantize']['ms'], plain_ms=b8['quantize']['plain_ms'],
        bound_ms=b8['quantize']['bound_ms'], bound_by='bytes', library_ms=None,
        per_forward='the input of every quantized conv of one batch-16 int8 predict, bf16 in'))
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
        max_abs_err=k8['max_abs_err'], ms=k8['ms'], plain_ms=k8['plain_ms'],
        bound_ms=k8['bound_ms'], bound_by=k8['bound_by'], library_ms=None,
        cudnn_bf16_two_convs_ms=k8['cudnn_bf16_two_convs_ms'],
        per_forward='one layer1 block at batch 16 (32 x 72 x 320 x 64), bf16 out'))
    print(json.dumps({'kernels': summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
