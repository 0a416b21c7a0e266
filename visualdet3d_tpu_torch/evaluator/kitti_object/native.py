"""ctypes bindings for the native matcher of the KITTI object evaluator
(counterpart of ``visualdet3d_tpu/evaluator/kitti_object/native.py``).

The port keeps its own copy of the C++ source, ``csrc/kitti_eval.cpp``,
built at first use with the host C++ compiler into
``visualdet3d_tpu_torch/build/`` (``ops/kernel_build.load_host``). A failed
build raises; ``eval_class`` never falls back to the Python matcher on its
own (the JAX package warns and falls back). The Python matcher,
``eval.compute_statistics``, runs only when a caller asks for it by name.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from visualdet3d_tpu_torch.ops import kernel_build


def load_library() -> ctypes.CDLL:
    """The matcher's library, built first if it is missing; raises if it
    cannot be built."""
    lib = kernel_build.load_host('kitti_eval')
    if lib.collect_thresholds.argtypes is None:
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        lp = ctypes.POINTER(ctypes.c_int64)
        lib.collect_thresholds.restype = ctypes.c_int
        lib.collect_thresholds.argtypes = [dp, ip, dp, ip, dp, ip, lp, lp,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_double, dp]
        lib.fused_statistics.restype = None
        lib.fused_statistics.argtypes = [dp, ip, dp, ip, dp, ip, lp, lp, dp, ip,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_double, dp, ctypes.c_int,
                                         ctypes.c_int, dp]
    return lib


class PackedEvalData:
    """Flatten per-image ragged arrays into the C layout."""

    def __init__(self, overlaps: List[np.ndarray], gt_datas: List[np.ndarray],
                 dt_datas: List[np.ndarray], ignored_gts: List[np.ndarray],
                 ignored_dets: List[np.ndarray], dontcares: List[np.ndarray]):
        n = len(overlaps)
        self.num_images = n
        self.gt_offsets = np.zeros(n + 1, np.int32)
        self.dt_offsets = np.zeros(n + 1, np.int32)
        self.dc_offsets = np.zeros(n + 1, np.int32)
        self.overlap_offsets = np.zeros(n + 1, np.int32)
        for i in range(n):
            self.gt_offsets[i + 1] = self.gt_offsets[i] + gt_datas[i].shape[0]
            self.dt_offsets[i + 1] = self.dt_offsets[i] + dt_datas[i].shape[0]
            self.dc_offsets[i + 1] = self.dc_offsets[i] + dontcares[i].shape[0]
            self.overlap_offsets[i + 1] = (self.overlap_offsets[i] +
                                           overlaps[i].size)
        cat = lambda arrs, w: (np.concatenate(
            [np.ascontiguousarray(a, np.float64).reshape(-1, w) for a in arrs])
            if sum(a.shape[0] for a in arrs) else np.zeros((0, w)))
        self.overlaps = np.concatenate(
            [np.ascontiguousarray(o, np.float64).reshape(-1) for o in overlaps]) \
            if sum(o.size for o in overlaps) else np.zeros(0)
        self.gt = cat(gt_datas, 5)
        self.dt = cat(dt_datas, 6)
        self.dc = cat(dontcares, 4)
        self.igt = np.concatenate([np.asarray(g, np.int64) for g in ignored_gts]) \
            if self.gt_offsets[-1] else np.zeros(0, np.int64)
        self.idt = np.concatenate([np.asarray(d, np.int64) for d in ignored_dets]) \
            if self.dt_offsets[-1] else np.zeros(0, np.int64)

    def _p(self, arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def collect_thresholds(self, lib, metric: int, min_overlap: float) -> np.ndarray:
        out = np.zeros(max(self.gt_offsets[-1], 1), np.float64)
        n = lib.collect_thresholds(
            self._p(self.overlaps, ctypes.c_double),
            self._p(self.overlap_offsets, ctypes.c_int),
            self._p(self.gt, ctypes.c_double),
            self._p(self.gt_offsets, ctypes.c_int),
            self._p(self.dt, ctypes.c_double),
            self._p(self.dt_offsets, ctypes.c_int),
            self._p(self.igt, ctypes.c_int64),
            self._p(self.idt, ctypes.c_int64),
            self.num_images, metric, min_overlap,
            self._p(out, ctypes.c_double))
        return out[:n]

    def fused_statistics(self, lib, metric: int, min_overlap: float,
                         thresholds: np.ndarray, compute_aos: bool) -> np.ndarray:
        thresholds = np.ascontiguousarray(thresholds, np.float64)
        pr = np.zeros((len(thresholds), 4), np.float64)
        lib.fused_statistics(
            self._p(self.overlaps, ctypes.c_double),
            self._p(self.overlap_offsets, ctypes.c_int),
            self._p(self.gt, ctypes.c_double),
            self._p(self.gt_offsets, ctypes.c_int),
            self._p(self.dt, ctypes.c_double),
            self._p(self.dt_offsets, ctypes.c_int),
            self._p(self.igt, ctypes.c_int64),
            self._p(self.idt, ctypes.c_int64),
            self._p(self.dc, ctypes.c_double),
            self._p(self.dc_offsets, ctypes.c_int),
            self.num_images, metric, min_overlap,
            self._p(thresholds, ctypes.c_double), len(thresholds),
            int(compute_aos), self._p(pr, ctypes.c_double))
        return pr
