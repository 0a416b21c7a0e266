"""Attribute-dict configs and config files (counterpart of
``visualdet3d_tpu/config.py``).

The repository's config files are Python that imports
``from visualdet3d_tpu.config import EasyDict``. :func:`cfg_from_file`
runs them with that one module name resolved to this module for the
duration of the run, so a config builds the port's ``EasyDict`` (whose
``__setitem__`` wraps nested dicts) and no module of the JAX package is
imported; any other ``visualdet3d_tpu`` import in a config fails.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os
import sys
import types
from typing import Any


class EasyDict(dict):
    """dict subclass with attribute access; recursively wraps nested dicts."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, EasyDict):
            return EasyDict(value)
        if isinstance(value, (list, tuple)):
            wrapped = [EasyDict._wrap(v) for v in value]
            return type(value)(wrapped) if isinstance(value, tuple) else wrapped
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, EasyDict._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def update(self, other=None, **kwargs):  # keep wrapping on update
        if other is not None:
            for k, v in dict(other).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def copy(self):
        return EasyDict(self)


JAX_CONFIG_MODULE = 'visualdet3d_tpu.config'


@contextlib.contextmanager
def _jax_config_name_resolved_here():
    """``visualdet3d_tpu.config`` is this module (and ``visualdet3d_tpu`` a
    package holding only it) until the block ends; whatever those names
    were bound to before is bound again after."""
    parent = types.ModuleType('visualdet3d_tpu')
    parent.__path__ = []  # a package with no submodule of its own
    parent.config = sys.modules[__name__]
    names = ('visualdet3d_tpu', JAX_CONFIG_MODULE)
    saved = {name: sys.modules.get(name) for name in names}
    sys.modules.update({'visualdet3d_tpu': parent, JAX_CONFIG_MODULE: sys.modules[__name__]})
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def cfg_from_file(cfg_filename: str) -> EasyDict:
    """Run a Python config file and return its module-level ``cfg`` as an
    ``EasyDict``. The file is run by path and not kept in ``sys.modules``."""
    if not cfg_filename.endswith('.py'):
        raise ValueError(f'config must be a .py file, got {cfg_filename}')
    cfg_filename = os.path.abspath(cfg_filename)
    module_name = '_visualdet3d_torch_cfg_' + os.path.splitext(os.path.basename(cfg_filename))[0]
    spec = importlib.util.spec_from_file_location(module_name, cfg_filename)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module  # importable during its own run (dataclasses etc.)
    try:
        with _jax_config_name_resolved_here():
            spec.loader.exec_module(module)
        cfg = getattr(module, 'cfg')
    finally:
        sys.modules.pop(module_name, None)
    if not isinstance(cfg, dict):
        raise TypeError(f'{cfg_filename}: `cfg` must be a dict, got {type(cfg).__name__}')
    return cfg if isinstance(cfg, EasyDict) else EasyDict(cfg)
