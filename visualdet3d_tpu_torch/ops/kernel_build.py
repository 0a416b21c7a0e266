"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``visualdet3d_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is not. Only sources in the package
are compiled. Without ``nvcc`` this raises: a CUDA tensor never falls back
to the plain path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels '
                       'of visualdet3d_tpu_torch are built from source at first use')


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together. The compiler's report (registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    out: Dict[str, Path] = {}
    jobs = []
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        report, _ = proc.communicate()
        so.with_name(so.name + '.log').write_text(report)
        if proc.returncode != 0:
            failed.append(f'nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{report}')
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError('\n'.join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        so = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]
