#!/usr/bin/env python3
"""Where the time of the two streaming kernels goes, on one CUDA card: K1,
the correlation volume (``csrc/correlation.cu``), and K6, the premul
lerp-accumulate (``premul_lerp_accum_kernel`` in ``csrc/deform_conv.cu``).

Run from the repository root (each mode builds variants of the source with
``nvcc``, all at once, loads each with ``ctypes`` and swaps it in under the
port's wrappers):

    python3 stream_study.py corr [NAMES]
    python3 stream_study.py premul [NAMES]
    python3 stream_study.py host

NAMES: comma-separated variant names (default all; ``as_is`` always runs).
Each variant is timed in device time (CUDA graphs, ``chip_smoke.graph_ms``)
on the same inputs, at the main path's shapes: K1 at the two calls of a
batch-16 Stereo3D predict (interleaved eyes, f32 and bf16), K6 at the 8 proj
DCNs of a batch-16 KM3D forward (on the same pre-multiplied tables). One JSON
line a shape and dtype (and one a forward), then the card's name and power
limit.

* ``corr``: ``no_products`` (the stages are loaded and the band stored, no
  products: the stream's time), ``no_store`` (nothing is written back),
  ``stages_3`` / ``stages_4`` (the ring's depth: 2 stages leave four blocks
  an SM, 3 three, 4 two), ``tile_128`` (items of 128 columns, 8 warps).
* ``premul``: ``l1_hit`` (every corner load reads the tap's slice of the
  image's first pixel, so that all hit L1: the kernel without its L2
  traffic), ``ldcg`` (the corner loads bypass L1: what L1 reuse between
  neighbouring samples gives now), ``pix2`` (2 pixels a lane, 8 loads in
  flight a tap, twice the blocks), ``pix2_blocks4`` (and registers capped
  for four blocks an SM), ``blocks1`` (no cap: one block an SM).

* ``host``: the host time of one call of each wrapper (K1 at the stride-8
  shape in bf16, K6 at the 12x40 proj shape), over 200 calls whose device
  work is shorter than their host work: what a CUDA-event time cannot go
  below.

``no_products``, ``no_store`` and ``l1_hit`` compute wrong values on
purpose: they only time; the other variants are checked against the plain
versions (K6 bit for bit). The substitutions match the sources' text
(``CORR_VARIANTS``, ``PREMUL_VARIANTS``); ``tests/test_torch_stream_study.py``
checks that each still does.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

import chip_smoke
from visualdet3d_tpu_torch.ops import cost_volume as cv
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import kernel_build

OUT = kernel_build.BUILD_DIR / 'stream_study'

CORR_F32_PRODUCTS = '''        if (live && k < nk) {
          const int lrow = 16 * warp + 4 * g4;'''
CORR_BF16_PRODUCTS = '''        if (live) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {  // two 32-channel halves of the chunk'''
CORR_STORE = '          for (int e = lane; e < n; e += 32) o[e] = from_f32<T>(wband[e]);'
CORR_VARIANTS = {
    'as_is': [],
    'no_products': [(CORR_F32_PRODUCTS, CORR_F32_PRODUCTS.replace('live && k < nk', 'false')),
                    (CORR_BF16_PRODUCTS, CORR_BF16_PRODUCTS.replace('(live)', '(false)'))],
    'no_store': [(CORR_STORE, '')],
    'stages_3': [('constexpr int kStages = 2;', 'constexpr int kStages = 3;')],
    'stages_4': [('constexpr int kStages = 2;', 'constexpr int kStages = 4;')],
    'tile_128': [('constexpr int kTileW = 64;', 'constexpr int kTileW = 128;'),
                 ('constexpr int kWarps = 4;', 'constexpr int kWarps = 8;')],
}
CORR_CHECKED = ('as_is', 'stages_3', 'stages_4', 'tile_128')

PREMUL_BOUNDS = '__launch_bounds__(kThreads, 2)\npremul_lerp_accum_kernel('
PREMUL_LOAD = '__ldg(reinterpret_cast<const uint4*>(yb + off[q]))'
PREMUL_VARIANTS = {
    'as_is': [],
    'l1_hit': [(PREMUL_LOAD, '__ldg(reinterpret_cast<const uint4*>(yb + k * C_out))')],
    'ldcg': [(PREMUL_LOAD, PREMUL_LOAD.replace('__ldg', '__ldcg'))],
    'pix2': [('constexpr int kPremulPix = 4;', 'constexpr int kPremulPix = 2;')],
    'pix2_blocks4': [('constexpr int kPremulPix = 4;', 'constexpr int kPremulPix = 2;'),
                     (PREMUL_BOUNDS, PREMUL_BOUNDS.replace('2)', '4)'))],
    'blocks1': [(PREMUL_BOUNDS, PREMUL_BOUNDS.replace(', 2)', ')'))],
}
PREMUL_CHECKED = ('as_is', 'ldcg', 'pix2', 'pix2_blocks4', 'blocks1')


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise SystemExit(f'stream_study: the source has no {old[:60]!r}: edit the study')
        text = text.replace(old, new)
    return text


def build_all(source: str, texts) -> dict:
    """{name: source text} -> {name: loaded library}, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src, lib = OUT / f'{source}_{name}.cu', OUT / f'lib{source}_{name}.so'
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f'stream_study: nvcc failed for {name}:\n{report}')
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def bind(lib: ctypes.CDLL, entries, argtypes) -> ctypes.CDLL:
    """The entry points' argument types, as the port's wrappers bind them."""
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def variant_libs(source: str, table, names):
    text = (kernel_build.CSRC_DIR / f'{source}.cu').read_text()
    names = ['as_is'] + [n for n in (names or table) if n != 'as_is']
    return build_all(source, {name: substitute(text, table[name]) for name in names})


def corr(names=None) -> None:
    libs = {name: bind(lib, cv._ENTRY.values(),
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                                     ctypes.c_void_p])
            for name, lib in variant_libs('correlation', CORR_VARIANTS, names).items()}
    gen = torch.Generator(device='cuda').manual_seed(1)
    shapes = {'stride4': (72, 320, 64, 24), 'stride8': (36, 160, 128, 24)}
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        total = dict.fromkeys(libs, 0.0)
        for shape, (h, w, c, d) in shapes.items():
            xs = [torch.randn((2 * chip_smoke.BATCH, h, w, c), generator=gen,
                              device='cuda').to(dtype) for _ in range(4)]
            ref = cv.correlation_volume_plain(xs[0][0::2].float(), xs[0][1::2].float(), d)
            row = dict(kernel='correlation_volume_interleaved', dtype=dt, shape=shape)
            for name, lib in libs.items():
                cv._correlation_lib = lambda lib=lib: lib
                if name in CORR_CHECKED:
                    err = (cv.correlation_volume_interleaved(xs[0], d).float() - ref).abs()
                    ok = (err.max() <= 1e-5) if dtype == torch.float32 else (
                        err <= chip_smoke.bf16_ulp(ref) + 1e-5).all()
                    chip_smoke.check(bool(ok), f'corr {name} {dt} {shape}: max abs err '
                                               f'{float(err.max())}')
                row[name] = chip_smoke.graph_ms(lambda x: cv.correlation_volume_interleaved(x, d),
                                                xs)
                total[name] += row[name]
            print(json.dumps(row), flush=True)
            del xs, ref
        print(json.dumps(dict(kernel='correlation_volume_interleaved', dtype=dt,
                              per_forward_ms=total)), flush=True)


def premul(names=None) -> None:
    libs = {name: bind(lib, [dc._PREMUL_ENTRY],
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
            for name, lib in variant_libs('deform_conv', PREMUL_VARIANTS, names).items()}
    gen = torch.Generator(device='cuda').manual_seed(33)
    total = dict.fromkeys(libs, 0.0)
    for count, h, w, c_in, c_out in chip_smoke.DCN_PROJ_SHAPES:
        runs, weight, bias = chip_smoke.dcn_inputs(torch, gen, chip_smoke.BATCH, h, w, c_in,
                                                   c_out, torch.bfloat16, 4)
        tables = [dc.premul_table(a[0], weight) for a in runs]
        ref = dc.premul_lerp_accumulate_plain(tables[0], *runs[0][1:], bias)
        row = dict(kernel='modulated_deform_conv_premul_accum', dtype='bf16',
                   shape=[h, w, c_in, c_out], count=count)
        for name, lib in libs.items():
            dc._deform_conv_lib = lambda lib=lib: lib
            if name in PREMUL_CHECKED:
                out = dc.premul_lerp_accumulate(tables[0], *runs[0][1:], bias)
                chip_smoke.check(torch.equal(out, ref), f'premul {name} {h}x{w} {c_in}->{c_out}: '
                                                        'differs from the plain version')
            row[name] = chip_smoke.graph_ms(
                lambda i: dc.premul_lerp_accumulate(tables[i], *runs[i][1:], bias),
                list(range(len(runs))))
            total[name] += count * row[name]
        print(json.dumps(row), flush=True)
        del runs, tables, ref
        torch.cuda.empty_cache()
    print(json.dumps(dict(kernel='modulated_deform_conv_premul_accum', dtype='bf16',
                          per_forward_ms=total)), flush=True)


def host() -> None:
    gen = torch.Generator(device='cuda').manual_seed(0)
    both = torch.randn((2, 36, 160, 128), generator=gen, device='cuda').to(torch.bfloat16)
    runs, weight, bias = chip_smoke.dcn_inputs(torch, gen, 1, 12, 40, 512, 256, torch.bfloat16, 1)
    table = dc.premul_table(runs[0][0], weight)
    calls = {'correlation_volume_interleaved': lambda: cv.correlation_volume_interleaved(both, 24),
             'modulated_deform_conv_premul_accum': lambda: dc.premul_lerp_accumulate(
                 table, *runs[0][1:], bias)}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(json.dumps(dict(kernel=name, host_us_per_call=host_us)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('stream_study: needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else ''
    names = sys.argv[2].split(',') if len(sys.argv) > 2 else None
    if mode == 'host':
        host()
    elif mode in ('corr', 'premul'):
        {'corr': corr, 'premul': premul}[mode](names)
    else:
        raise SystemExit(__doc__)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
