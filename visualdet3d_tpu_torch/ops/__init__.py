"""Ops of the port; kernels are built by ``kernel_build``.

Each module of a hand-written kernel counts its wrappers' launches in its
``LAUNCHES`` dict; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them all to 0.
"""
from __future__ import annotations

import importlib
from typing import Dict

LAUNCH_COUNTERS = ('deform_conv', 'cost_volume', 'int8_conv', 'int8_block', 'stereo_bm')


def _counting_modules():
    return [importlib.import_module(f'{__name__}.{name}') for name in LAUNCH_COUNTERS]


def launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of the port's ops, by kernel name."""
    counts = {}
    for module in _counting_modules():
        counts.update(module.LAUNCHES)
    return counts


def reset_launch_counts() -> None:
    """Every kernel launch counter of the port's ops set to 0."""
    for module in _counting_modules():
        module.reset_launch_counts()
