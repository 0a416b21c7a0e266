"""Name -> class registries (counterpart of ``visualdet3d_tpu/registry.py``).

The port keeps its own instances: the JAX package's registries already hold
``Stereo3D`` and friends, and registering a name twice raises. Importing
``visualdet3d_tpu_torch.pipelines.trainers`` fills ``PIPELINE_DICT``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    """A simple name -> object registry, filled by ``@REG.register_module``."""

    def __init__(self, name: str = ''):
        self.name = name
        self._module_dict: Dict[str, Any] = {}

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __getitem__(self, key: str) -> Any:
        if key not in self._module_dict:
            raise KeyError(
                f"'{key}' is not registered in registry '{self.name}'. "
                f"Available: {sorted(self._module_dict)}")
        return self._module_dict[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._module_dict)

    def keys(self):
        return self._module_dict.keys()

    def get(self, key: str, default: Any = None) -> Any:
        return self._module_dict.get(key, default)

    def _register(self, module: Any, name: Optional[str] = None, force: bool = False) -> Any:
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"'{key}' already registered in registry '{self.name}'")
        self._module_dict[key] = module
        return module

    def register_module(self, module: Any = None, *, name: Optional[str] = None,
                        force: bool = False) -> Callable:
        if module is not None:
            return self._register(module, name=name, force=force)

        def _decorator(mod):
            return self._register(mod, name=name, force=force)
        return _decorator


BACKBONE_DICT = Registry('backbones')
DETECTOR_DICT = Registry('detectors')
PIPELINE_DICT = Registry('pipelines')
