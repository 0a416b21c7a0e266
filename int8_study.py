#!/usr/bin/env python3
"""Where the time of the fused int8 block kernel (K8) and the activation
quantize goes, on one CUDA card.

Run from the repository root:

    python3 int8_study.py variants
    python3 int8_study.py parent DIR

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

The substitutions match the source's text (``VARIANTS``);
``tests/test_torch_int8_block_tiles.py`` checks that each still does.
"""
from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('int8_study: needs a CUDA card')
    mode = sys.argv[1] if len(sys.argv) > 1 else 'variants'
    if mode == 'variants':
        variants()
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
