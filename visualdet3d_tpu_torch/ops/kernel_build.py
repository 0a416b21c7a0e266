"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``visualdet3d_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is not. Only sources in the package
are compiled. Without ``nvcc`` this raises: a CUDA tensor never falls back
to the plain path.

Host sources are built the same way with the host's compilers and raise
the same way without one: C (``csrc/<name>.c``: the PNG unfilter of
``data/image_io.py``) with ``$CC``, else ``cc``; C++ (``csrc/<name>.cpp``:
the KITTI evaluator's matcher, ``evaluator/kitti_object/native.py``) with
``$CXX``, else ``c++``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

HOST_CFLAGS = ('-O3', '-shared', '-fPIC', '-std=c99')
HOST_CXXFLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_loaded: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()  # the data loader's threads load the host library together


def find_nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels '
                       'of visualdet3d_tpu_torch are built from source at first use')


def find_cc() -> str:
    for cand in (os.environ.get('CC'), 'cc', 'gcc', 'clang'):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError('no C compiler found ($CC, cc, gcc, clang): the host C sources '
                       'of visualdet3d_tpu_torch (csrc/*.c) are built at first use')


def find_cxx() -> str:
    for cand in (os.environ.get('CXX'), 'c++', 'g++', 'clang++'):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError('no C++ compiler found ($CXX, c++, g++, clang++): the host C++ '
                       'sources of visualdet3d_tpu_torch (csrc/*.cpp) are built at first use')


def host_source(name: str) -> Path:
    """``csrc/<name>.c`` or ``csrc/<name>.cpp``, whichever exists."""
    for suffix in ('.c', '.cpp'):
        src = CSRC_DIR / f'{name}{suffix}'
        if src.exists():
            return src
    raise FileNotFoundError(f'no host source csrc/{name}.c or csrc/{name}.cpp')


def _host_flags(src: Path):
    return HOST_CXXFLAGS if src.suffix == '.cpp' else HOST_CFLAGS


def host_library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.c`` (or ``.cpp``) lives for the
    current source."""
    src = host_source(name)
    h = hashlib.sha256(' '.join(_host_flags(src)).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-host-{h.hexdigest()[:16]}.so'


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for the host source ``csrc/<name>.c`` (or
    ``.cpp``), built first with the host's C (C++) compiler if it is
    missing."""
    key = f'host:{name}'
    with _host_lock:
        if key not in _loaded:
            so = host_library_path(name)
            if not so.exists():
                src = host_source(name)
                compiler = find_cxx() if src.suffix == '.cpp' else find_cc()
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
                proc = subprocess.run([compiler, *_host_flags(src), '-o', str(tmp), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f'the compiler failed for csrc/{src.name} '
                                       f'(rc {proc.returncode}):\n{proc.stdout}')
                os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
            _loaded[key] = ctypes.CDLL(str(so))
        return _loaded[key]


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
