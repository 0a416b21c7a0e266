#!/usr/bin/env python3
"""Where the time of the DCN forward and dW kernels goes, on one CUDA card.

Run from the repository root (``variants`` and ``laps`` build variants of
``visualdet3d_tpu_torch/csrc/deform_conv.cu`` with ``nvcc``, load each with
``ctypes`` and swap it in under the port's wrappers):

    python3 dcn_study.py variants [SHAPES]
    python3 dcn_study.py laps [SHAPES]
    python3 dcn_study.py split

SHAPES: comma-separated HxWxC_inxC_out of the KM3D neck (batch 16), default
96x320x64x64,48x160x128x128,24x80x256x256. Each mode prints one JSON line a
shape (or step) and dtype, then the card's name and power limit.

* ``variants``: the source as it is and with one thing changed, each timed
  in turn on the same inputs: ``no_mma`` (the consumers skip the products:
  the producers' time), ``l1_hit`` (every corner load reads the image's
  first pixel, so that all hit L1: the gather without its memory traffic),
  ``producers_copy`` / ``consumers_copy`` (the producers, or the consumers,
  copy the second operand and build the forward's tables, in both dtypes),
  ``one_group`` (the producers in one group). The forward by CUDA events,
  dx and dW by device time from a profiler pass.
* ``laps``: ``clock64()`` laps of the forward's phases, summed by one
  producer and one consumer thread of every block into a ``__device__``
  array: cycles per stage (per tile for the tables and the epilogue).
* ``split``: dW's split of ``dw_plan`` against half and twice as many
  splits and a single wave of blocks, at the 7 neck shapes, in turns (plan,
  half, double, wave, then back): dW's device time (split sums + reduce,
  profiler) per shape and per training step.

``no_mma`` and ``l1_hit`` compute wrong values on purpose: they only time;
the other variants are checked against the plain versions, and each split
variant's dW against the plan's. The substitutions match the source's text
(``VARIANTS``, ``LAP_SUBS``); ``tests/test_torch_dcn_pipeline.py`` checks
that each still does.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys

import torch

import chip_smoke
from visualdet3d_tpu_torch.ops import deform_conv as dc
from visualdet3d_tpu_torch.ops import kernel_build

OUT = kernel_build.BUILD_DIR / 'study'
SRC = kernel_build.CSRC_DIR / 'deform_conv.cu'
DEFAULT_SHAPES = '96x320x64x64,48x160x128x128,24x80x256x256'

FWD_MMA = '''        warp_mma_stage<T, false, C::CH>(acc, stage_a(it), C::a_ld, stage_b(it), C::b_ld, 32 * wm,
                                        64 * wn, lane);'''
DW_MMA = '''      warp_mma_stage<T, true, C::PK>(acc, stage_a(it), C::a_ld, stage_b(it), C::b_ld, 32 * wm,
                                     64 * wn, lane);'''
VARIANTS = {
    'as_is': [],
    'no_mma': [(FWD_MMA, ''), (DW_MMA, '')],
    'l1_hit': [('reinterpret_cast<const Raw*>(xc + i)', 'reinterpret_cast<const Raw*>(xc)')],
    'producers_copy': [('constexpr bool kConsumersCopy = C::kBf16 && C::CW == 8;',
                        'constexpr bool kConsumersCopy = false;')],
    'consumers_copy': [('constexpr bool kConsumersCopy = C::kBf16 && C::CW == 8;',
                        'constexpr bool kConsumersCopy = true;')],
    'one_group': [('return cw == 4 ? (dw ? 4 : 3) : 2;', 'return 1;')],
}
CHECKED = ('as_is', 'producers_copy', 'consumers_copy', 'one_group')


def substitute(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise SystemExit(f'dcn_study: the source has no {old[:60]!r}: edit the study')
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f'{name}.cu', OUT / f'lib{name}.so'
    src.write_text(text)
    r = subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, '-o', str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f'dcn_study: nvcc failed for {name}:\n{r.stdout}{r.stderr}')
    return ctypes.CDLL(str(lib))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points' argument types, as the port's wrappers bind them."""
    for name in dc._ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in dc._BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vd3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vd3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def use(lib: ctypes.CDLL) -> None:
    """The port's wrappers on this library."""
    dc._deform_conv_lib = lambda: lib


def shapes_of(arg: str):
    return [tuple(int(v) for v in s.split('x')) for s in arg.split(',')]


def inputs(gen, h, w, c_in, c_out, dtype, n=5):
    runs, weight, bias = chip_smoke.dcn_inputs(torch, gen, chip_smoke.BATCH, h, w, c_in, c_out,
                                               dtype, n)
    grads = [torch.randn((chip_smoke.BATCH, h, w, c_out), generator=gen,
                         device='cuda').to(dtype) for _ in range(n)]
    return runs, weight, bias, grads


def variants(shapes) -> None:
    text = SRC.read_text()
    libs = {name: bind(build(name, substitute(text, subs)))
            for name, subs in VARIANTS.items()}
    gen = torch.Generator(device='cuda').manual_seed(3)
    for dt, dtype in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        for h, w, c_in, c_out in shapes:
            runs, weight, bias, grads = inputs(gen, h, w, c_in, c_out, dtype)
            pairs = list(zip(runs, grads))
            row = dict(dtype=dt, shape=[h, w, c_in, c_out])
            for name, lib in libs.items():
                use(lib)
                what = f'{name} {dt} {h}x{w} {c_in}->{c_out}'
                if name in CHECKED:
                    chip_smoke.dcn_check(torch, dc, runs[0], weight, bias, what)
                    chip_smoke.bwd_check(torch, dc, runs[0], weight, grads[0], what)
                row[f'fwd_{name}'] = chip_smoke.cuda_ms(
                    lambda a: dc.modulated_deform_conv(*a, weight, bias), runs)
                dev = chip_smoke.bwd_device_ms(torch, lambda a: dc.modulated_deform_conv_backward(
                    *a[0], weight, a[1]), pairs)
                row[f'dw_{name}'] = dev['dw'] + dev['dw_reduce']
                row[f'dx_{name}'] = dev['dx']
            use(libs['as_is'])
            print(json.dumps(row), flush=True)
            del runs, grads, pairs
            torch.cuda.empty_cache()


# producer (a stage of its group): the tables (bf16: the wait for the consumers' tables),
# the wait for an empty stage (and the other groups' stages), the gather (f32: and the W
# copy), the wait for its cp.async copies; consumer: the wait for a full stage, the W copy
# and (a tile's first stage) the next tables, the products, the epilogue
LAP_NAMES = ('tables', 'empty_wait', 'gather', 'cp_wait', 'full_wait', 'copy_and_tables', 'mma',
             'epilogue')

# clock64() stamps of one producer and one consumer thread a block in the forward kernel
LAP_SUBS = [
    ('constexpr int kWsThreads = 512;',
     '__device__ unsigned long long g_laps[16];\n'
     '#define LAP(i) if (lap_on) { const long long t1 = clock64(); '
     'atomicAdd(&g_laps[i], (unsigned long long)(t1 - lt)); lt = t1; }\n'
     'constexpr int kWsThreads = 512;'),
    ('''    long long it = 0;
    int tj = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const T* xb''', '''    long long it = 0;
    int tj = 0;
    long long lt = clock64();
    const bool lap_on = ptid == 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const T* xb'''),
    ('''      for (int k = 0; k < K; ++k) {
        const int4* k_idx''', '''      LAP(0)
      if (lap_on) atomicAdd(&g_laps[9], 1ull);
      for (int k = 0; k < K; ++k) {
        const int4* k_idx'''),
    ('''          if (it >= kWsStages) named_bar_sync(1 + kWsStages + it % kWsStages, C::kHandoff);
          T* s_a = stage_a(it);''', '''          if (it >= kWsStages) named_bar_sync(1 + kWsStages + it % kWsStages, C::kHandoff);
          LAP(1)
          if (lap_on) atomicAdd(&g_laps[8], 1ull);
          T* s_a = stage_a(it);'''),
    ('''          cp_async_wait_all();
          named_bar_arrive(1 + it % kWsStages, C::kHandoff);
        }
      }
    }
  } else {''', '''          LAP(2)
          cp_async_wait_all();
          LAP(3)
          named_bar_arrive(1 + it % kWsStages, C::kHandoff);
        }
      }
    }
  } else {'''),
    ('''    long long it = 0;
    int tj = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const long long b''', '''    long long it = 0;
    int tj = 0;
    long long lt = clock64();
    const bool lap_on = tid == 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++tj) {
      const long long b'''),
    ('''        named_bar_sync(1 + it % kWsStages, C::kHandoff);
        if (kConsumersCopy && j == 0''', '''        named_bar_sync(1 + it % kWsStages, C::kHandoff);
        LAP(4)
        if (lap_on) atomicAdd(&g_laps[10], 1ull);
        if (kConsumersCopy && j == 0'''),
    (FWD_MMA, 'LAP(5)\n' + FWD_MMA + '\nLAP(6)'),
    ('''          if (second) dst[1] = from_f32<T>(v1);
        }
      }
    }''', '''          if (second) dst[1] = from_f32<T>(v1);
        }
      }
      LAP(7)
    }'''),
]
LAP_READERS = '''
extern "C" int vd3d_read_laps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_laps, sizeof(g_laps));
}
extern "C" int vd3d_reset_laps() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_laps, z, sizeof(z));
}
'''


def laps(shapes) -> None:
    text = substitute(SRC.read_text(), LAP_SUBS) + LAP_READERS
    lib = bind(build('laps', text))
    use(lib)
    gen = torch.Generator(device='cuda').manual_seed(3)
    for dt, dtype in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        for h, w, c_in, c_out in shapes:
            runs, weight, bias, _ = inputs(gen, h, w, c_in, c_out, dtype, 3)
            dc.modulated_deform_conv(*runs[0], weight, bias)
            torch.cuda.synchronize()
            lib.vd3d_reset_laps()
            ms = chip_smoke.cuda_ms(lambda a: dc.modulated_deform_conv(*a, weight, bias),
                                    runs[1:], warmup=0)
            got = (ctypes.c_ulonglong * 16)()
            lib.vd3d_read_laps(got)
            # a producer thread runs its group's stages, a consumer thread every stage
            stages, tiles, c_stages = got[8], max(got[9], 1), got[10]
            row = dict(dtype=dt, shape=[h, w, c_in, c_out], ms_with_laps=ms,
                       stages_of_a_producer_group=stages, stages=c_stages, tiles=tiles,
                       cycles_per_stage={name: got[i] / (stages if i < 4 else c_stages)
                                         for i, name in enumerate(LAP_NAMES)})
            row['cycles_per_tile'] = {'tables': got[0] / tiles, 'epilogue': got[7] / tiles}
            print(json.dumps(row), flush=True)


@contextlib.contextmanager
def split_variant(variant):
    """dW's split count under a variant of ``dw_plan``: 'plan', 'half' (half
    the plan's splits), 'double', or 'wave' (as many as fill the SMs once);
    each made valid as the plan makes it (no split empty)."""
    planned = dc.dw_plan

    def plan(chunks, c_in, c_out, taps=9, n_sm=132):
        s = planned(chunks, c_in, c_out, taps, n_sm)
        s = {'plan': s, 'half': s // 2, 'double': 2 * s,
             'wave': n_sm // dc.dw_tiles(c_in, c_out, taps)}[variant]
        s = max(1, min(chunks, s))
        return -(-chunks // -(-chunks // s))
    dc.dw_plan = plan
    try:
        yield
    finally:
        dc.dw_plan = planned


SPLIT_TURNS = ('plan', 'half', 'double', 'wave', 'wave', 'double', 'half', 'plan')


def split() -> None:
    """Each variant's dW within 2^-7 of the plan's plus 1e-5 of its largest
    value (other splits sum in other orders)."""
    gen = torch.Generator(device='cuda').manual_seed(28)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        tot = dict.fromkeys(('plan', 'half', 'double', 'wave'), 0.0)
        for count, h, w, c_in, c_out in chip_smoke.DCN_SHAPES:
            runs, weight, _, grads = inputs(gen, h, w, c_in, c_out, dtype, 3)
            pairs = list(zip(runs, grads))
            times = {v: [] for v in tot}
            dws = {}
            for variant in SPLIT_TURNS:
                with split_variant(variant):
                    dev = chip_smoke.bwd_device_ms(
                        torch, lambda a: dc.modulated_deform_conv_backward(*a[0], weight, a[1]),
                        pairs)
                    dws[variant] = dc.modulated_deform_conv_backward(
                        *pairs[0][0], weight, pairs[0][1])[3].float()
                    splits = dc.dw_plan(dc.dw_stages(chip_smoke.BATCH, h, w, dtype), c_in, c_out,
                                        9, n_sm)
                times[variant].append((dev['dw'] + dev['dw_reduce'], splits))
            ref = dws['plan']
            top = float(ref.abs().max())
            for variant, dw in dws.items():
                err = float((dw - ref).abs().max())
                chip_smoke.check(bool(torch.isfinite(dw).all()) and err <= (2 ** -7 + 1e-5) * top,
                                 f'split {dt} {h}x{w} {c_in}->{c_out} {variant}: dW differs from '
                                 f'the plan\'s by {err}')
            row = {v: dict(ms=statistics.mean(t for t, _ in ts), splits=ts[0][1])
                   for v, ts in times.items()}
            for v in tot:
                tot[v] += count * row[v]['ms']
            print(json.dumps(dict(dtype=dt, shape=[h, w, c_in, c_out], count=count,
                                  fastest=min(tot, key=lambda v: row[v]['ms']), **row)),
                  flush=True)
            del runs, grads, pairs
            torch.cuda.empty_cache()
        print(json.dumps(dict(dtype=dt, batch=chip_smoke.BATCH, per_step_ms=tot)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit('dcn_study: needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else 'variants'
    if mode == 'split':
        split()
    elif mode in ('variants', 'laps'):
        {'variants': variants, 'laps': laps}[mode](
            shapes_of(sys.argv[2] if len(sys.argv) > 2 else DEFAULT_SHAPES))
    else:
        raise SystemExit(__doc__)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
