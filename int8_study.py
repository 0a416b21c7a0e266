#!/usr/bin/env python3
"""Where the time of the fused int8 block kernel (K8) and the activation
quantize goes, on one CUDA card.

Run from the repository root:

    python3 int8_study.py variants
    python3 int8_study.py parent DIR
    python3 int8_study.py b8 [DIR]
    python3 int8_study.py params
    python3 int8_study.py predict DIR [MODEL ...]

Each mode prints one JSON line a measurement, then the card's name and power
limit.

* ``variants``: K8 (``visualdet3d_tpu_torch/csrc/int8_block.cu``) as it is
  and with one thing changed by text substitution, built in parallel and
  timed in turns (two rounds) at layer1's geometry at batch 16 (32 x 72 x
  320 x 64), bf16 and f32 out, in CUDA events and device time (CUDA
  graphs): ``no_mma`` (no products: the epilogues, the staging and the
  barriers), ``mma_only`` (the products; each epilogue replaced by one byte
  that keeps its accumulators live), ``mma_conv1_epilogue`` /
  ``mma_conv2_epilogue`` (the products and one of the two epilogues),
  ``deep3`` (the three conv1 units of a consumer issued at once on three
  accumulator sets), ``float_clamp`` (the requantize clipped in float
  before the conversion). Only ``as_is``, ``deep3`` and ``float_clamp`` are
  checked against the plain version; the others compute wrong values on
  purpose.
* ``parent DIR``: the quantize and K8 of the checkout in DIR (its
  ``csrc/int8_conv.cu`` and ``csrc/int8_block.cu``, built from DIR) against
  this tree's, under this tree's wrappers (the entry points have the same
  arguments), in turns (parent, current, current, parent): the quantize at
  every input shape of the batch-16 int8 stereo predict, weighted by its
  count per predict, and K8 on the real layer1_0 entries and input, in CUDA
  events and device time; both bit-exact against their plain versions.

* ``b8 [DIR]``: B8 and the quantize at shapes whose plan this tree
  changed (the channel pitch, the GEMM view of 1x1 convs, the 3-stage
  ring: ``B8_SHAPES``), this
  tree's against DIR's sources under DIR's wrappers, in turns, in CUDA
  events and device time, beside the bound and, at 1x1 shapes,
  ``torch._int_mm`` (``b8``).

* ``params``: B8 (``csrc/int8_conv.cu``) as it is and with one int added
  to its kernel's parameter struct ``TmaConv`` (``PARAMS_PLUS_ONE``: 136
  bytes in place of 128), built in parallel and timed in turns (two
  rounds) at ``PARAMS_SHAPES``, device time: what the source's
  ``static_assert`` on the struct's size keeps.

* ``predict DIR [MODEL ...]``: the int8 predicts end to end, this tree's
  and DIR's, each in a process of its own run from its root with its own
  ``chip_smoke.py`` (its kernels built from its sources), in turns
  (parent, current, current, parent): ms a batch-16 predict over 6
  distinct batches (two rounds), the batch-1 p50 over 12 calls, and one
  predict's device time from the profiler. MODEL: ``stereo``
  (``entry.build_int8_system``, every conv on its own) or a key of
  ``chip_smoke.MONO_INT8_MODELS`` (the default: stereo, ground_aware, dcn).

The substitutions match the source's text (``VARIANTS``, ``PARAMS_PLUS_ONE``);
``tests/test_torch_int8_block_tiles.py`` checks that each still does.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from visualdet3d_tpu_torch.ops import int8_block as ib
from visualdet3d_tpu_torch.ops import int8_conv as ic
from visualdet3d_tpu_torch.ops import kernel_build

OUT = kernel_build.BUILD_DIR / 'int8_study'
SRC = kernel_build.CSRC_DIR / 'int8_block.cu'
LAYER1 = (32, 72, 320)

WGMMA = '      wgmma_s8_n64(acc, da + off'
REQUANT = 'auto requant_unit = [&](const int(&acc)[32], int u) {'
STORE = 'auto store_row = [&](const int(&acc)[32], int oy) {'
# an epilogue replaced by one shared-memory byte a thread, so that ptxas keeps
# the accumulators (and the products) live without a branch
LIVE = '{ { int s_ = 0; for (int e = 0; e < 32; ++e) s_ ^= acc[e]; %s = (uint8_t)s_; } return;'
CONV1 = '''    issue_unit<kXPlane>(acc0, xs_addr, 64 * wg, base);
    issue_unit<kXPlane>(acc1, xs_addr, 64 * (wg + kWGs), base);
    wgmma_wait<1>();
    named_barrier(1, 128 * kWGs);  // every consumer's conv2 of the last tile is done
    requant_unit(acc0, wg);
    issue_unit<kXPlane>(acc0, xs_addr, 64 * (wg + 2 * kWGs), base);
    wgmma_wait<1>();
    requant_unit(acc1, wg + kWGs);
    wgmma_wait<0>();
    requant_unit(acc0, wg + 2 * kWGs);'''
CONV1_DEEP3 = '''    int acc2[32];
    issue_unit<kXPlane>(acc0, xs_addr, 64 * wg, base);
    issue_unit<kXPlane>(acc1, xs_addr, 64 * (wg + kWGs), base);
    issue_unit<kXPlane>(acc2, xs_addr, 64 * (wg + 2 * kWGs), base);
    wgmma_wait<2>();
    named_barrier(1, 128 * kWGs);
    requant_unit(acc0, wg);
    wgmma_wait<1>();
    requant_unit(acc1, wg + kWGs);
    wgmma_wait<0>();
    requant_unit(acc2, wg + 2 * kWGs);'''
CLAMP = '  return (int8_t)max(min(__float2int_rn(h), 127), -127);'
VARIANTS = {
    'as_is': [],
    'no_mma': [(WGMMA, '      if (false) wgmma_s8_n64(acc, da + off')],
    'mma_only': [(REQUANT, REQUANT[:-1] + LIVE % 'hs[t + 128 * wg]'),
                 (STORE, STORE[:-1] + LIVE % 'stg[t]')],
    'mma_conv1_epilogue': [(STORE, STORE[:-1] + LIVE % 'stg[t]')],
    'mma_conv2_epilogue': [(REQUANT, REQUANT[:-1] + LIVE % 'hs[t + 128 * wg]')],
    'deep3': [(CONV1, CONV1_DEEP3)],
    'float_clamp': [(CLAMP, '  h = fminf(fmaxf(rintf(h), -127.f), 127.f);\n'
                            '  return (int8_t)__float2int_rn(h);')],
}
CHECKED = ('as_is', 'deep3', 'float_clamp')


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f'int8_study: the source has not one {old[:60]!r}: edit the study')
        text = text.replace(old, new)
    return text


def build_all(jobs) -> dict:
    """{name: (source text, include dir)} -> {name: loaded library}, one
    nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in jobs.items():
        src, lib = OUT / f'{name}.cu', OUT / f'lib{name}.so'
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, '-I', str(include), '-o',
             str(lib), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f'int8_study: nvcc failed for {name}:\n{out}')
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].vd3d_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].vd3d_cuda_error_string.restype = ctypes.c_char_p
    return libs


def use_block(lib: ctypes.CDLL) -> None:
    """The port's K8 wrapper on this library."""
    fn = lib.vd3d_int8_basic_block
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ib._int8_block_lib = lambda: lib


def use_quantize(lib: ctypes.CDLL) -> None:
    """The port's quantize wrapper on this library."""
    fn = lib.vd3d_int8_quantize
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ic._quantize_entry = lambda: fn


def block_inputs(gen, system=None, n=4):
    """K8's weights, parameters and n inputs at layer1's geometry: the real
    layer1_0 entries and input of the int8 system, else random ones."""
    if system is None:
        w1, w2 = (torch.randint(-127, 128, (64, 3, 3, 64), generator=gen, device='cuda',
                                dtype=torch.int8) for _ in range(2))
        params = torch.stack([
            torch.rand(64, generator=gen, device='cuda') * 2e-5 + 1e-5,
            torch.randn(64, generator=gen, device='cuda') * 0.1, torch.full((64,), 9.0, device='cuda'),
            torch.rand(64, generator=gen, device='cuda') * 2e-5 + 1e-5,
            torch.randn(64, generator=gen, device='cuda') * 0.1, torch.full((64,), 0.02, device='cuda')])
        xs = [torch.randint(-40, 41, (*LAYER1, 64), generator=gen, device='cuda', dtype=torch.int8)
              for _ in range(n)]
        return w1, w2, params.contiguous(), xs
    be = chip_smoke.block_entry(system)
    w1, w2 = be['e1']['kernel_q'], be['e2']['kernel_q']
    params = ib.block_params(be['e1'], be['e2'], be['bn1_scale'], be['bn1_shift'],
                             be['bn2_scale'], be['bn2_shift'])
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2
    import numpy as np
    batch = (torch.randn((chip_smoke.BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'),
             torch.randn((chip_smoke.BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'))
    P2 = torch.as_tensor(np.tile(KITTI_P2, (chip_smoke.BATCH, 1, 1)), device='cuda')
    x = chip_smoke.layer1_input(torch, system, batch, P2).permute(0, 2, 3, 1).contiguous()
    inv = 1.0 / be['e1']['act_scale'].float()
    xs = [ic.quantize_act_plain(x * (1 + 0.05 * i), inv) for i in range(n)]
    return w1, w2, params, xs


def time_block(w1, w2, params, xs, check):
    out = {}
    for name, dt in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        if check:
            got = ib.int8_basic_block(xs[0], w1, w2, params, dt)
            ok = bool(torch.equal(got, ib.int8_basic_block_plain(xs[0], w1, w2, params, dt)))
            chip_smoke.check(ok, f'int8_study: K8 {name} differs from the plain version')
        fn = lambda t: ib.int8_basic_block(t, w1, w2, params, dt)
        out[name] = dict(ms=chip_smoke.cuda_ms(fn, xs), graph_ms=chip_smoke.graph_ms(fn, xs))
    return out


def variants() -> None:
    text = SRC.read_text()
    libs = build_all({name: (substitute(text, subs), kernel_build.CSRC_DIR)
                      for name, subs in VARIANTS.items()})
    w1, w2, params, xs = block_inputs(torch.Generator(device='cuda').manual_seed(1))
    for rnd in range(2):
        for name, lib in libs.items():
            use_block(lib)
            r = time_block(w1, w2, params, xs, check=name in CHECKED)
            print(json.dumps({'mode': 'variants', 'variant': name, 'round': rnd,
                              'shape': [*LAYER1, 64], **r}), flush=True)


def parent(path: str) -> None:
    from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, build_int8_system
    import numpy as np
    csrc = Path(path) / 'visualdet3d_tpu_torch' / 'csrc'
    jobs = {}
    for who, where in (('parent', csrc), ('current', kernel_build.CSRC_DIR)):
        for name in ('int8_conv', 'int8_block'):
            jobs[f'{who}_{name}'] = ((where / f'{name}.cu').read_text(), where)
    libs = build_all(jobs)
    system = build_int8_system(device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(3)
    batch = (torch.randn((chip_smoke.BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'),
             torch.randn((chip_smoke.BATCH, *IMAGE_HW, 3), generator=gen, device='cuda'))
    P2 = torch.as_tensor(np.tile(KITTI_P2, (chip_smoke.BATCH, 1, 1)), device='cuda')
    use_quantize(libs['current_int8_conv'])
    shapes = {}
    for (b, h, w, c, *_), count in chip_smoke.int8_conv_shapes(torch, system, (*batch, P2)).items():
        shapes[(b, h, w, c)] = shapes.get((b, h, w, c), 0) + count
    w1, w2, params, xs = block_inputs(gen, system)
    qgen = torch.Generator(device='cuda').manual_seed(17)
    qin = {s: [(torch.randn(s, generator=qgen, device='cuda') * 3).to(torch.bfloat16)
               for _ in range(4)] for s in shapes}
    inv = torch.tensor(127 / 9.0, device='cuda')
    for turn, who in enumerate(('parent', 'current', 'current', 'parent')):
        use_quantize(libs[f'{who}_int8_conv'])
        use_block(libs[f'{who}_int8_block'])
        total = dict(ms=0.0, graph_ms=0.0)
        per_shape = []
        for s, count in sorted(shapes.items()):
            x = qin[s]
            chip_smoke.check(torch.equal(ic.quantize_act(x[0], inv), ic.quantize_act_plain(x[0], inv)),
                             f'int8_study: {who} quantize {s} differs from the plain version')
            fn = lambda t: ic.quantize_act(t, inv)
            r = dict(ms=chip_smoke.cuda_ms(fn, x), graph_ms=chip_smoke.graph_ms(fn, x))
            per_shape.append(dict(shape=list(s), per_predict=count, **r))
            for key in total:
                total[key] += count * r[key]
        k8 = time_block(w1, w2, params, xs, check=True)
        print(json.dumps({'mode': 'parent', 'turn': turn, 'who': who,
                          'quantize_per_predict': total, 'quantize_launches': sum(shapes.values()),
                          'k8': k8, 'quantize_per_shape': per_shape}), flush=True)


# B8 at the shapes this tree's plan changed, (B, H, W, C_in, C_out, k,
# padding), bias (folded BN), bf16 out: the two the parent's plan sent to its
# cp.async kernel (the stereo 72-channel 3x3 at stride 8 and GAC's
# LookGround 1x1, C_in 1025, at stride 16) at batch 16 and 1, 1x1 convs
# whose boxes the GEMM view changed (GAC's 23 + 22 at 18x80, KM3D's 12x40),
# and 3x3 convs on the 3-stage ring (stereo, KM3D)
B8_SHAPES = tuple((b, h, w, c, n, k, pad) for b in (16, 1) for h, w, c, n, k, pad in (
    (36, 160, 72, 72, 3, ((1, 1), (1, 1))), (18, 80, 1025, 1024, 1, ((0, 0), (0, 0))))) + (
    (16, 18, 80, 256, 1024, 1, ((0, 0), (0, 0))), (16, 18, 80, 1024, 256, 1, ((0, 0), (0, 0))),
    (16, 12, 40, 1280, 512, 1, ((0, 0), (0, 0))),
    # 128-channel tiles on 128-byte chunks, on a 3-stage ring (two blocks an SM)
    (32, 36, 160, 128, 128, 3, ((1, 1), (1, 1))), (16, 18, 80, 384, 384, 3, ((1, 1), (1, 1))),
    (16, 18, 80, 1408, 576, 3, ((1, 1), (1, 1))), (16, 48, 160, 128, 128, 3, ((1, 1), (1, 1))))


def parent_int8_conv(path: str):
    """DIR's ``ops/int8_conv.py`` as a module of its own, on DIR's
    ``csrc/int8_conv.cu`` built here."""
    import importlib.util
    import types
    csrc = Path(path) / 'visualdet3d_tpu_torch' / 'csrc'
    lib = build_all({'parent_int8_conv': ((csrc / 'int8_conv.cu').read_text(), csrc)})[
        'parent_int8_conv']
    spec = importlib.util.spec_from_file_location(
        'parent_int8_conv', Path(path) / 'visualdet3d_tpu_torch' / 'ops' / 'int8_conv.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.kernel_build = types.SimpleNamespace(load=lambda name: lib)
    return mod


@contextlib.contextmanager
def image_view():
    """This tree's plan with every conv on its own (B, H, W) boxes: no GEMM
    view of the 1x1 convs."""
    view = ic.gemm_view
    ic.gemm_view = lambda b, h, w, *args, **kwargs: (b, h, w)
    ic.plan_int8_conv.cache_clear()
    try:
        yield
    finally:
        ic.gemm_view = view
        ic.plan_int8_conv.cache_clear()


def b8(path=None) -> None:
    """B8 and the quantize at B8_SHAPES on this tree (pitched, as
    ``Int8Conv2d`` runs them; at 1x1 shapes also without the GEMM view,
    ``current_image_view``) and, with DIR, on DIR's sources under DIR's
    wrappers (its layout), in turns (parent, current, current, parent): CUDA
    events and device time (CUDA graphs), each bit for bit against the plain
    sums; the bound; at 1x1 shapes ``torch._int_mm`` on the same sums (K
    zero-padded to a multiple of 8)."""
    part, _ = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
    bw, peak = chip_smoke.CARD_PEAKS[part][0], chip_smoke.int8_peak(part)
    who_of = {'current': ic}
    if path is not None:
        who_of['parent'] = parent_int8_conv(path)
    turns = ('parent', 'current', 'current', 'parent') if path is not None else ('current',)
    gen = torch.Generator(device='cuda').manual_seed(21)
    inv = torch.tensor(127 / 9.0, device='cuda')
    for b, h, w, c, n, k, pad in B8_SHAPES:
        pitch = ic.channel_pitch(c)
        xs = [chip_smoke.pitched_int8(torch, ic, gen, (b, h, w, c)) for _ in range(4)]
        wq = chip_smoke.pitched_int8(torch, ic, gen, (n, k, k, c))
        acts = [(torch.randn((b, h, w, c), generator=gen, device='cuda') * 3).to(torch.bfloat16)
                for _ in range(4)]
        scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3
        bias = torch.randn((n,), generator=gen, device='cuda')
        ref = ic.int8_conv2d_plain(xs[0], wq, padding=pad, c_in=c)
        ho, wo = ic.output_hw(h, w, k, k, (1, 1), pad, (1, 1))
        ops = 2 * b * ho * wo * n * k * k * c
        nbytes = b * h * w * c + n * k * k * c + 2 * b * ho * wo * n + 8 * n
        row = dict(shape=[b, h, w, c, n, k], pitch=pitch,
                   plan=ic.plan_int8_conv(b, h, w, c, n, k, k, padding=pad)._asdict(),
                   bound_ms=max(nbytes / bw, ops / peak) * 1e3,
                   bound_by='bytes' if nbytes / bw >= ops / peak else 'operations',
                   quantize_bound_ms=b * h * w * (2 * c + pitch) / bw * 1e3)
        runs = {}
        for who in turns + (('current_image_view',) * 2 if k == 1 else ()):
            mod = who_of.get(who, ic)
            if who.startswith('current'):
                x_in, w_in, q = xs, wq, dict(c_in=c)
                qfn = lambda t: ic.quantize_act(t, inv, pitch)  # noqa: E731
            else:  # the parent's layout: C_in channels, no pitch
                x_in = [x[..., :c].contiguous() for x in xs]
                w_in, q = wq[..., :c].contiguous(), {}
                qfn = lambda t: mod.quantize_act(t, inv)  # noqa: E731
            with image_view() if who == 'current_image_view' else contextlib.nullcontext():
                got = mod.int8_conv2d(x_in[0], w_in, padding=pad, **q)
                chip_smoke.check(torch.equal(got, ref), f'int8_study: {who} B8 {row["shape"]} '
                                 'differs from the plain sums')
                chip_smoke.check(torch.equal(qfn(acts[0])[..., :c],
                                             ic.quantize_act_plain(acts[0], inv)),
                                 f'int8_study: {who} quantize {row["shape"]} differs')
                fn = lambda t: mod.int8_conv2d(t, w_in, padding=pad, scale=scale,  # noqa: E731
                                               bias=bias, out_dtype=torch.bfloat16, **q)
                runs.setdefault(who, []).append(dict(
                    ms=chip_smoke.cuda_ms(fn, x_in), device_ms=chip_smoke.graph_ms(fn, x_in),
                    quantize_ms=chip_smoke.cuda_ms(qfn, acts),
                    quantize_device_ms=chip_smoke.graph_ms(qfn, acts)))
        for who, rs in runs.items():
            row[who] = {key: sum(r[key] for r in rs) / len(rs) for key in rs[0]}
            row[who]['share_of_bound_device'] = row['bound_ms'] / row[who]['device_ms']
            row[who]['device_ms_by_turn'] = [r['device_ms'] for r in rs]
        if k == 1:
            a, mm = chip_smoke.int_mm_1x1(torch, ic, xs, wq, c)
            row.update(int_mm_k=a[0].shape[1], int_mm_ms=chip_smoke.cuda_ms(mm, a),
                       int_mm_device_ms=chip_smoke.graph_ms(mm, a))
        print(json.dumps({'mode': 'b8', **row}), flush=True)


CONV_SRC = kernel_build.CSRC_DIR / 'int8_conv.cu'
PARAMS_PLUS_ONE = [('  int stage_bytes, bar_offset;', '  int stage_bytes, bar_offset, unused;'),
                   ('static_assert(sizeof(TmaConv) <= 128', 'static_assert(sizeof(TmaConv) <= 136')]
PARAMS_SHAPES = ((16, 36, 160, 128, 128, 3, ((1, 1), (1, 1))), (16, 36, 160, 72, 72, 3, ((1, 1), (1, 1))),
                 (16, 18, 80, 1024, 256, 1, ((0, 0), (0, 0))),
                 (16, 18, 80, 1025, 1024, 1, ((0, 0), (0, 0))))


def params() -> None:
    text = CONV_SRC.read_text()
    libs = build_all({'as_is': (text, kernel_build.CSRC_DIR),
                      'one_more_int': (substitute(text, PARAMS_PLUS_ONE), kernel_build.CSRC_DIR)})
    for lib in libs.values():
        lib.vd3d_int8_conv2d_wgmma.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 24 + \
            [ctypes.c_void_p]
        lib.vd3d_int8_conv2d_wgmma.restype = ctypes.c_int
    gen = torch.Generator(device='cuda').manual_seed(23)
    for b, h, w, c, n, k, pad in PARAMS_SHAPES:
        xs = [chip_smoke.pitched_int8(torch, ic, gen, (b, h, w, c)) for _ in range(3)]
        wq = chip_smoke.pitched_int8(torch, ic, gen, (n, k, k, c))
        scale = torch.rand((n,), generator=gen, device='cuda') * 1e-3
        ref = ic.int8_conv2d_plain(xs[0], wq, padding=pad, c_in=c)
        res = {}
        for rnd in range(2):
            for name, lib in libs.items():
                ic._int8_conv_lib = lambda lib=lib: lib
                chip_smoke.check(torch.equal(ic.int8_conv2d(xs[0], wq, padding=pad, c_in=c), ref),
                                 f'int8_study: {name} differs from the plain sums')
                fn = lambda t: ic.int8_conv2d(t, wq, padding=pad, scale=scale,  # noqa: E731
                                              out_dtype=torch.bfloat16, c_in=c)
                res.setdefault(name, []).append(chip_smoke.graph_ms(fn, xs))
        print(json.dumps({'mode': 'params', 'shape': [b, h, w, c, n, k], 'device_ms': res}),
              flush=True)


PREDICT = r'''
import json, statistics, sys, time
import numpy as np
import torch
import chip_smoke as cs
from visualdet3d_tpu_torch.ops import kernel_build
kernel_build.build(['int8_conv', 'int8_block', 'correlation', 'deform_conv'])
for model in sys.argv[1:]:
    if model == 'stereo':
        from visualdet3d_tpu_torch.entry import IMAGE_HW, KITTI_P2, build_int8_system
        system = build_int8_system(device='cuda')
        gen = torch.Generator(device='cuda').manual_seed(3)
        batches = [(torch.randn((16, *IMAGE_HW, 3), generator=gen, device='cuda'),
                    torch.randn((16, *IMAGE_HW, 3), generator=gen, device='cuda'))
                   for _ in range(7)]
        P2 = torch.as_tensor(np.tile(KITTI_P2, (16, 1, 1)), device='cuda')
        call = lambda b, p: system.predict(*b, p)
        one = lambda b: tuple(t[:1].clone() for t in b)
    else:
        system, _ = cs.build_mono_int8(torch, model)
        images, P2, _ = cs.mono_inputs(torch, model, 7, 16, seed=64)
        batches = images
        call = lambda b, p: system.predict(b, p)
        one = lambda b: b[:1].clone()
    system.cfg.inference_dtype, system.cfg.int8_block = 'int8', None
    call(batches[0], P2)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(2):
        t0 = time.perf_counter()
        for b in batches[1:]:
            call(b, P2)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) * 1e3 / 6)
    lats = cs.bs1_latencies(torch, lambda b: call(b, P2[:1]), [one(b) for b in batches])
    wall, _, _, device_ms = cs.device_profile(torch, lambda: call(batches[1], P2))
    print(json.dumps({'model': model, 'ms_per_batch': rounds, 'bs1_p50_ms': statistics.median(lats),
                      'device_ms': device_ms, 'profile_wall_ms': wall}), flush=True)
    del system
    torch.cuda.empty_cache()
'''


def predict(path: str, models) -> None:
    models = models or ['stereo', 'ground_aware', 'dcn']
    roots = {'parent': str(Path(path).resolve()), 'current': str(Path(__file__).resolve().parent)}
    for turn, who in enumerate(('parent', 'current', 'current', 'parent')):
        proc = subprocess.run([sys.executable, '-c', PREDICT, *models], cwd=roots[who],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            raise SystemExit(f'int8_study: the {who} predict failed:\n{proc.stderr[-3000:]}')
        for line in proc.stdout.splitlines():
            if line.startswith('{"model"'):
                print(json.dumps({'mode': 'predict', 'turn': turn, 'who': who,
                                  **json.loads(line)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('int8_study: needs a CUDA card')
    mode = sys.argv[1] if len(sys.argv) > 1 else 'variants'
    if mode == 'variants':
        variants()
    elif mode == 'predict' and len(sys.argv) > 2:
        predict(sys.argv[2], sys.argv[3:])
    elif mode == 'params':
        params()
    elif mode == 'b8':
        b8(sys.argv[2] if len(sys.argv) > 2 else None)
    elif mode == 'parent' and len(sys.argv) > 2:
        parent(sys.argv[2])
    else:
        raise SystemExit(__doc__)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
