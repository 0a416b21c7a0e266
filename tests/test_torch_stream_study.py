"""``stream_study.py``'s substitutions against the kernel sources, on the CPU.

The study builds variants of ``csrc/correlation.cu`` (K1) and of K6 in
``csrc/deform_conv.cu`` by text substitution and times them on the card.
Each substitution must find its text in the source and change it, so that
the study builds what it says; each variant is listed here.
"""
import importlib.util
import pathlib

import pytest

from visualdet3d_tpu_torch.ops import kernel_build

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _study():
    spec = importlib.util.spec_from_file_location('stream_study', ROOT / 'stream_study.py')
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    return study


CORR = ['no_products', 'no_store', 'stages_3', 'stages_4', 'tile_128']
PREMUL = ['l1_hit', 'ldcg', 'pix2', 'pix2_blocks4', 'blocks1']


@pytest.mark.parametrize('source,variant', [('correlation', v) for v in CORR]
                         + [('deform_conv', v) for v in PREMUL])
def test_study_patches_match_the_source(source, variant):
    study = _study()
    table = study.CORR_VARIANTS if source == 'correlation' else study.PREMUL_VARIANTS
    text = (kernel_build.CSRC_DIR / f'{source}.cu').read_text()
    subs = table[variant]
    assert subs
    for old, _ in subs:
        assert old in text, old[:80]
    assert study.substitute(text, subs) != text


def test_study_lists_every_variant():
    study = _study()
    assert set(study.CORR_VARIANTS) - {'as_is'} == set(CORR)
    assert set(study.PREMUL_VARIANTS) - {'as_is'} == set(PREMUL)
    # the variants that compute right values are checked on the card
    assert set(study.CORR_CHECKED) == {'as_is', 'stages_3', 'stages_4', 'tile_128'}
    assert set(study.PREMUL_CHECKED) == {'as_is', 'ldcg', 'pix2', 'pix2_blocks4', 'blocks1'}
