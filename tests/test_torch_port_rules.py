"""Rules of the port that no parity test shows.

* Nothing under ``visualdet3d_tpu_torch/``, nor ``chip_smoke.py`` or
  ``dcn_study.py``, imports JAX, flax, optax or the JAX package. The scan is
  static (an AST walk), because this test process has JAX imported already.
  The package imports neither root script.
* The entry points (inference, the KM3D and MonoFlex systems and trainers)
  run on the card by default and raise without CUDA instead of running on
  the CPU.
* Kernels build from the package's sources only (``csrc/correlation.cu``,
  ``csrc/deform_conv.cu``, ``csrc/int8_conv.cu``, ``csrc/int8_block.cu``),
  include nothing but CUDA's headers and the package's own, rebuild when a
  source changes, and raise when ``nvcc`` is missing.
* The int8 path has no ``try`` that catches: a kernel that fails to build or
  launch raises, and never gives way to the plain version.
* Every launcher of ``csrc/deform_conv.cu`` is bound by its wrapper, and
  ``chip_smoke.py``'s ``kernels`` summary names each DCN kernel with the
  TPU kernel it replaces.
"""
import ast
import pathlib
import re

import pytest
import torch

from visualdet3d_tpu_torch import device as device_lib
from visualdet3d_tpu_torch.ops import kernel_build

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'visualdet3d_tpu')


def _port_sources():
    build = kernel_build.BUILD_DIR  # build outputs, not sources
    files = sorted(p for p in (ROOT / 'visualdet3d_tpu_torch').rglob('*.py')
                   if build not in p.parents) + [ROOT / 'chip_smoke.py', ROOT / 'dcn_study.py']
    assert len(files) > 10 and all(p.exists() for p in files)
    return files


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(
                node.func, 'id', None)) in ('import_module', '__import__'):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split('.')[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    offenders = [f'{path.relative_to(ROOT)}: {root}'
                 for path in _port_sources() for root in _imported_roots(path)
                 if root in FORBIDDEN]
    assert offenders == []


def test_package_imports_no_root_script():
    """The smoke and the study drive the package; it never imports them."""
    offenders = [f'{path.relative_to(ROOT)}: {root}'
                 for path in _port_sources() if ROOT / 'visualdet3d_tpu_torch' in path.parents
                 for root in _imported_roots(path) if root in ('chip_smoke', 'dcn_study')]
    assert offenders == []


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert device_lib.resolve_device() == torch.device('cuda')
    assert device_lib.resolve_device('cpu') == torch.device('cpu')


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from visualdet3d_tpu_torch import entry as entry_lib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry_lib.entry()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry_lib.build_system(depth=18, preprocessed=str(tmp_path))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        kernel_build.find_nvcc()


def test_library_is_keyed_by_the_source(monkeypatch, tmp_path):
    """An edited source maps to a new library name, so it is rebuilt; the
    same source maps to the same one, so it is not."""
    monkeypatch.setattr(kernel_build, 'CSRC_DIR', tmp_path)
    (tmp_path / 'k.cu').write_text('__global__ void k() {}\n')
    first = kernel_build.library_path('k')
    assert kernel_build.library_path('k') == first
    (tmp_path / 'k.cu').write_text('__global__ void k() { }\n')
    assert kernel_build.library_path('k') != first
    assert first.parent == kernel_build.BUILD_DIR


def test_kernel_sources_target_hopper():
    assert (kernel_build.CSRC_DIR / 'correlation.cu').exists()
    assert 'arch=compute_90a,code=sm_90a' in kernel_build.NVCC_FLAGS


def test_km3d_entry_point_raises_without_cuda(monkeypatch):
    from visualdet3d_tpu_torch import entry as entry_lib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry_lib.build_km3d_system()


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_km3d_trainer_entry_point_raises_without_cuda(monkeypatch, compute_dtype):
    from visualdet3d_tpu_torch import entry as entry_lib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry_lib.build_km3d_trainer(compute_dtype=compute_dtype)


def test_km3d_trainer_runs_on_the_cpu_when_asked():
    """``device='cpu'`` builds the trainer on the CPU (the plain DCN under
    autograd), with the configured Adam and MultiStepLR schedule."""
    from visualdet3d_tpu_torch import entry as entry_lib
    system, state, step = entry_lib.build_km3d_trainer(device='cpu', batch_size=16)
    assert next(system.net.parameters()).device.type == 'cpu'
    assert isinstance(state.optimizer.torch_optimizer, torch.optim.Adam)
    per_epoch = state.optimizer.schedule  # 232 updates an epoch at batch 16
    assert per_epoch(0) == pytest.approx(1.25e-4)
    assert per_epoch(90 * 232) == pytest.approx(1.25e-5)
    assert per_epoch(120 * 232) == pytest.approx(1.25e-6)
    assert callable(step) and state.step == 0
    # the step takes batches of the size the schedule counts in
    with pytest.raises(ValueError, match='a batch of 2 images'):
        step({'images': torch.zeros((2, 8, 8, 3)), 'gts': {}, 'P2': torch.zeros((2, 3, 4))}, 0.0)
    assert state.step == 0


def test_every_kernel_source_is_in_the_package():
    names = sorted(p.stem for p in kernel_build.CSRC_DIR.glob('*.cu'))
    assert names == ['correlation', 'deform_conv', 'int8_block', 'int8_conv']
    for name in names:
        src = (kernel_build.CSRC_DIR / f'{name}.cu').read_text()
        assert 'extern "C"' in src and 'vd3d_cuda_error_string' in src


def test_kernel_sources_include_only_cuda_and_their_own_headers():
    own = {p.name for p in kernel_build.CSRC_DIR.glob('*.cuh')}
    assert own == {'int8_common.cuh'}
    for src in sorted(kernel_build.CSRC_DIR.glob('*.cu*')):
        for line in src.read_text().splitlines():
            if not line.startswith('#include'):
                continue
            header = line.split(None, 1)[1].strip()
            if header.startswith('"'):
                assert header.strip('"') in own, (src.name, header)
            else:
                assert not any(word in header for word in FORBIDDEN), (src.name, header)


INT8_PATH = ('ops/int8_conv.py', 'ops/int8_block.py', 'models/quant.py', 'models/fold_bn.py')


@pytest.mark.parametrize('module', INT8_PATH)
def test_int8_path_has_no_catching_try(module):
    tree = ast.parse((ROOT / 'visualdet3d_tpu_torch' / module).read_text())
    handlers = [node.lineno for node in ast.walk(tree)
                if isinstance(node, ast.Try) and node.handlers]
    assert handlers == [], f'{module}: try with except at lines {handlers}'


def test_int8_entry_point_raises_without_cuda(monkeypatch):
    from visualdet3d_tpu_torch import entry as entry_lib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry_lib.build_int8_system(int8_block='pallas')


@pytest.mark.parametrize('builder', ['build_monoflex_system', 'build_monoflex_trainer'])
def test_monoflex_entry_points_raise_without_cuda(monkeypatch, builder):
    from visualdet3d_tpu_torch import entry as entry_lib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        getattr(entry_lib, builder)()


def test_monoflex_trainer_runs_on_the_cpu_when_asked():
    """``configs/monoflex.py``'s optimizer: Adam, lr 3e-4, clipping at norm
    35, MultiStepLR at epochs 60 and 80; batches of 8."""
    from visualdet3d_tpu_torch import entry as entry_lib
    system, state, step = entry_lib.build_monoflex_trainer(device='cpu')
    assert type(system).__name__ == 'MonoFlex'
    assert next(system.net.parameters()).device.type == 'cpu'
    assert isinstance(state.optimizer.torch_optimizer, torch.optim.Adam)
    assert state.optimizer.clip_norm == 35.0
    per_epoch = state.optimizer.schedule  # 464 updates an epoch at batch 8
    assert per_epoch(0) == pytest.approx(3e-4)
    assert per_epoch(60 * 464) == pytest.approx(3e-5)
    assert per_epoch(80 * 464) == pytest.approx(3e-6)
    with pytest.raises(ValueError, match='a batch of 2 images'):
        step({'images': torch.zeros((2, 8, 8, 3)), 'gts': {}, 'P2': torch.zeros((2, 3, 4))}, 0.0)


def test_deform_conv_launchers_are_bound_and_summarised():
    src = (kernel_build.CSRC_DIR / 'deform_conv.cu').read_text()
    launchers = re.findall(r'^int (vd3d_\w+)\(', src, re.M)
    assert sorted(launchers) == sorted(
        f'vd3d_{name}' for name in (
            'modulated_deform_conv_f32', 'modulated_deform_conv_bf16',
            'modulated_deform_conv_alltaps_bf16', 'premul_lerp_accumulate_bf16',
            'modulated_deform_conv_backward_f32', 'modulated_deform_conv_backward_bf16'))
    wrapper = (ROOT / 'visualdet3d_tpu_torch' / 'ops' / 'deform_conv.py').read_text()
    assert all(f"'{name}'" in wrapper for name in launchers)
    smoke = (ROOT / 'chip_smoke.py').read_text()
    for name, body in (('modulated_deform_conv[', 161), ('modulated_deform_conv_alltaps[', 255),
                       ('modulated_deform_conv_premul_accum[', 418),
                       ('modulated_deform_conv_backward_input[', 663),
                       ('modulated_deform_conv_backward_weight[', 663)):
        assert name in smoke, name
        assert f"'visualdet3d_tpu/ops/deform_conv.py:{body}'" in smoke, body
