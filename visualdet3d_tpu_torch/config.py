"""Attribute-dict configs (counterpart of ``visualdet3d_tpu/config.py``)."""
from __future__ import annotations

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
