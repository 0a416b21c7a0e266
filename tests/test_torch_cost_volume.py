"""The port's cost-volume ops against the JAX package, on the CPU.

The CUDA kernel cannot run here; its wrappers take the plain PyTorch version
for CPU tensors, which these tests hold against the JAX reference (the
Pallas kernels in interpret mode and the XLA formulation). On the card,
``chip_smoke.py`` holds the kernel against the same plain version.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualdet3d_tpu.ops.cost_volume import (
    concat_volume as jax_concat_volume,
    correlation_volume_pallas,
    correlation_volume_pallas_interleaved,
    correlation_volume_xla,
)
from visualdet3d_tpu_torch.ops import cost_volume as cv

# f32: only the order of the C-term sums differs between the frameworks
ATOL = 1e-5


@pytest.mark.parametrize('h,w,num_disp', [(8, 32, 8), (12, 32, 8), (8, 6, 8)],
                         ids=['h8', 'h12_tail', 'disp_over_width'])
def test_interleaved_plain_matches_jax(h, w, num_disp):
    rng = np.random.default_rng(100 * h + w)
    both = rng.standard_normal((4, h, w, 16)).astype(np.float32)
    ref_xla = np.asarray(correlation_volume_xla(jnp.asarray(both[0::2]),
                                                jnp.asarray(both[1::2]), num_disp))
    ref_pallas = np.asarray(correlation_volume_pallas_interleaved(
        jnp.asarray(both), num_disp, interpret=True))
    out = cv.correlation_volume_interleaved(torch.from_numpy(both), num_disp).numpy()
    assert out.shape == (2, h, w, num_disp)
    np.testing.assert_allclose(out, ref_pallas, atol=ATOL)
    np.testing.assert_allclose(out, ref_xla, atol=ATOL)
    if num_disp > w:
        assert np.all(out[..., w:] == 0)


@pytest.mark.parametrize('w,num_disp', [(32, 8), (6, 8)], ids=['w32', 'disp_over_width'])
def test_separate_eyes_plain_matches_jax(w, num_disp):
    rng = np.random.default_rng(3 + w)
    left = rng.standard_normal((2, 4, w, 16)).astype(np.float32)
    right = rng.standard_normal((2, 4, w, 16)).astype(np.float32)
    ref_xla = np.asarray(correlation_volume_xla(jnp.asarray(left), jnp.asarray(right), num_disp))
    ref_pallas = np.asarray(correlation_volume_pallas(jnp.asarray(left), jnp.asarray(right),
                                                      num_disp, interpret=True))
    out = cv.correlation_volume(torch.from_numpy(left), torch.from_numpy(right),
                                num_disp).numpy()
    np.testing.assert_allclose(out, ref_pallas, atol=ATOL)
    np.testing.assert_allclose(out, ref_xla, atol=ATOL)


def test_plain_bf16_accumulates_in_f32():
    """bf16 in: the sum runs in f32 on the upcast inputs and only the
    result is rounded, the kernel's rule."""
    rng = np.random.default_rng(5)
    both = torch.from_numpy(rng.standard_normal((2, 3, 16, 32)).astype(np.float32))
    both16 = both.to(torch.bfloat16)
    out = cv.correlation_volume_interleaved(both16, 6)
    assert out.dtype == torch.bfloat16
    ref = cv.correlation_volume_interleaved(both16.float(), 6).to(torch.bfloat16)
    assert torch.equal(out, ref)


def test_concat_volume_matches_jax_exactly():
    rng = np.random.default_rng(4)
    for w, num_disp in ((8, 3), (4, 6)):
        left = rng.standard_normal((2, 3, w, 5)).astype(np.float32)
        right = rng.standard_normal((2, 3, w, 5)).astype(np.float32)
        ref = np.asarray(jax_concat_volume(jnp.asarray(left), jnp.asarray(right), num_disp))
        out = cv.concat_volume(torch.from_numpy(left), torch.from_numpy(right), num_disp)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_cpu_tensors_take_the_plain_path_without_launching():
    cv.reset_launch_counts()
    both = torch.randn(4, 2, 8, 4)
    plain = cv.correlation_volume_plain(both[0::2], both[1::2], 3)
    assert torch.equal(cv.correlation_volume_interleaved(both, 3), plain)
    assert torch.equal(cv.correlation_volume(both[0::2], both[1::2], 3), plain)
    assert cv.LAUNCHES == {'correlation_volume': 0, 'correlation_volume_interleaved': 0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor selects the plain version; any other device must
    reach the kernel's checks (here: not CUDA, so they raise)."""
    both = torch.empty(4, 2, 8, 4, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_volume_interleaved(both, 3)
    with pytest.raises(ValueError, match='CUDA'):
        cv.correlation_volume(both[0::2], both[1::2], 3)
