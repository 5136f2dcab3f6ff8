"""MFCC front-end, offline MFCC pipeline, template averager and the bench
wakeword of the PyTorch port, against the JAX package on the CPU.

Tolerance: the numpy constant builders and the averager are copies, so they
are compared for equality. The torch ops run fp32 matmuls against the JAX
HIGHEST tier; they are compared at rtol 1e-5 with an absolute floor of 1e-4
of the MFCC range (|mfcc| reaches ~30): summation order differs between the
two GEMM libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu.mfcc.averager import average_templates as jax_average_templates
from rustpotter_tpu.mfcc.offline import mfcc_pipeline as jax_mfcc_pipeline
from rustpotter_tpu.ops import frontend as jfe
from rustpotter_tpu_torch.mfcc.averager import average_templates
from rustpotter_tpu_torch.mfcc.offline import mfcc_pipeline
from rustpotter_tpu_torch.ops import frontend as tfe
from rustpotter_tpu_torch.synthetic import bench_utterances, build_bench_wakeword

torch.set_num_threads(2)

RTOL = 1e-5
MFCC_ATOL = 1e-4


@pytest.mark.parametrize("n_coeff", [6, 17])
def test_constant_builders_equal_jax(n_coeff):
    np.testing.assert_array_equal(tfe.hamming_window(), jfe.hamming_window())
    np.testing.assert_array_equal(
        tfe.mel_filter_bank(16000, 240, n_coeff), jfe.mel_filter_bank(16000, 240, n_coeff)
    )
    np.testing.assert_array_equal(tfe.dct_matrix(n_coeff), jfe.dct_matrix(n_coeff))
    for a, b in zip(tfe.dft_matrices(), jfe.dft_matrices()):
        np.testing.assert_array_equal(a, b)
    t, j = tfe.get_constants(n_coeff), jfe.get_constants(n_coeff)
    for name in ("hamming", "mel_fb_t", "dct_t", "dft_cos", "dft_sin"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_elementwise_ops_match_jax():
    rng = np.random.default_rng(1)
    shifts = rng.normal(0, 0.1, (7, 3, 160)).astype(np.float32)
    np.testing.assert_allclose(
        tfe.pre_emphasis(torch.tensor(shifts)).numpy(),
        np.asarray(jfe.pre_emphasis(jnp.asarray(shifts))), rtol=RTOL, atol=1e-7,
    )
    np.testing.assert_allclose(
        tfe.rms_level(torch.tensor(shifts)).numpy(),
        np.asarray(jfe.rms_level(jnp.asarray(shifts))), rtol=RTOL,
    )
    feats = rng.normal(0, 5, (50, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tfe.cmn(torch.tensor(feats)).numpy(), np.asarray(jfe.cmn(jnp.asarray(feats))),
        rtol=RTOL, atol=1e-5,
    )
    pre = rng.normal(0, 0.1, (40, 480)).astype(np.float32)
    shifts = rng.normal(0, 0.1, (12, 160)).astype(np.float32)
    np.testing.assert_array_equal(
        tfe.frames_from_shifts(torch.tensor(shifts)).numpy(),
        np.asarray(jfe.frames_from_shifts(jnp.asarray(shifts))),
    )
    for n_coeff in (6, 17):
        want = np.asarray(jfe.mfcc_from_frames(jnp.asarray(pre), jfe.get_constants(n_coeff)))
        got = tfe.mfcc_from_frames(torch.tensor(pre), n_coeff).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=MFCC_ATOL)


@pytest.fixture(scope="module")
def utterances():
    return bench_utterances()


def test_mfcc_pipeline_and_averager_match_jax(utterances):
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = [np.asarray(jax_mfcc_pipeline(w, 17)) for w in utterances]
    got = [mfcc_pipeline(w, 17, device="cpu") for w in utterances]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=MFCC_ATOL)
    # the averager is a numpy copy: equal outputs on equal inputs
    np.testing.assert_array_equal(average_templates(want), jax_average_templates(want))


def test_bench_wakeword_matches_jax_bench():
    jww, jutt = bench.build_bench_wakeword()
    ww, utt = build_bench_wakeword(device="cpu")
    np.testing.assert_array_equal(utt, jutt)
    assert sorted(ww.samples_features) == sorted(jww.samples_features)
    for k, m in jww.samples_features.items():
        np.testing.assert_allclose(ww.samples_features[k], m, rtol=RTOL, atol=MFCC_ATOL)
    np.testing.assert_allclose(ww.avg_features, jww.avg_features, rtol=RTOL, atol=MFCC_ATOL)
    assert (ww.name, ww.rms_level, ww.mfcc_size) == (jww.name, jww.rms_level, jww.mfcc_size)
