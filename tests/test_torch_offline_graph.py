"""The offline MFCC extraction of the PyTorch port (`mfcc/offline.py`) on the
CPU, against the JAX package's jitted `mfcc_pipeline` and `compute_mfccs`,
and the rule by which the card keeps its graphs (`ShapeGraphs`):

  (a) `mfcc_pipeline` at 3 lengths x 2 coefficient counts against JAX's, at
      `tests/test_torch_frontend.py`'s RTOL / MFCC_ATOL;
  (b) `compute_mfccs` is the host encoder (`encode_wav`) then the pipeline,
      against JAX's `compute_mfccs` on the same WAV bytes;
  (c) a CPU call keeps no graph and makes no capture;
  (d) the key cache with its step maker stubbed (no card): a key captures at
      its second call and replays from its third, and past the bound the
      least recently used key is dropped, graph and all.
The graphs themselves run on the card: tests/test_torch_lifecycle_cuda.py.
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu.mfcc.offline import compute_mfccs as jax_compute_mfccs
from rustpotter_tpu.mfcc.offline import mfcc_pipeline as jax_mfcc_pipeline
from rustpotter_tpu_torch.constants import SAMPLES_PER_SHIFT
from rustpotter_tpu_torch.mfcc import offline
from rustpotter_tpu_torch.synthetic import training_wavs

torch.set_num_threads(2)

RTOL = 1e-5  # tests/test_torch_frontend.py
MFCC_ATOL = 1e-4


def _samples(frames: int, seed: int = 0) -> np.ndarray:
    """(frames + 3) shifts of a chirp in noise, from a seed."""
    n = (frames + 3) * SAMPLES_PER_SHIFT
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.3 * np.sin(2 * np.pi * (300 + 700 * t / t[-1]) * t) + 0.02 * rng.normal(size=n)
    return sig.astype(np.float32)


@pytest.mark.parametrize("coefficients", [7, 17])
@pytest.mark.parametrize("frames", [20, 57, 100])
def test_mfcc_pipeline_matches_jax(frames, coefficients):
    samples = _samples(frames, seed=frames)
    got = offline.mfcc_pipeline(samples, coefficients, device="cpu")
    want = np.asarray(jax_mfcc_pipeline(samples, coefficients))
    assert got.shape == want.shape == (frames, coefficients - 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MFCC_ATOL)


def test_compute_mfccs_is_the_encoder_then_the_pipeline():
    wav = next(iter(training_wavs(42, 1, seed=2).values()))
    samples, rms = offline.encode_wav(wav)
    got, got_rms = offline.compute_mfccs(wav, 16, device="cpu")
    assert got_rms == rms and len(samples) % SAMPLES_PER_SHIFT == 0
    np.testing.assert_array_equal(got, offline.mfcc_pipeline(samples, 17, device="cpu"))
    want, want_rms = jax_compute_mfccs(wav, 16)
    assert got_rms == pytest.approx(want_rms, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MFCC_ATOL)


def test_a_cpu_call_keeps_no_graph(monkeypatch):
    graphs = offline.ShapeGraphs()
    monkeypatch.setattr(offline, "GRAPHS", graphs)
    samples = _samples(20)
    first = offline.mfcc_pipeline(samples, 17, device="cpu")
    second = offline.mfcc_pipeline(samples, 17, device="cpu")
    np.testing.assert_array_equal(first, second)
    assert graphs.keys() == [] and graphs.captures == 0


class _Step:
    """A stand-in for a key's GraphedStep: made, never run."""


def test_a_key_captures_at_its_second_call_and_replays_after():
    graphs = offline.ShapeGraphs(bound=4, make_step=_Step)
    key = (0, 171, 17)
    assert graphs.step(key) is None  # first call: eager
    assert graphs.captures == 0 and graphs.keys() == [key]
    step = graphs.step(key)  # second: a step, which captures at its call
    assert isinstance(step, _Step) and graphs.captures == 1
    for _ in range(78):  # 80 recordings of one length: one capture
        assert graphs.step(key) is step
    assert graphs.captures == 1
    # five lengths seen once each (the bench templates): eager, no capture
    for n in (103, 101, 99, 97):
        assert graphs.step((0, n, 17)) is None
    assert graphs.captures == 1


def test_past_the_bound_the_least_recently_used_key_is_dropped():
    graphs = offline.ShapeGraphs(bound=3, make_step=_Step)
    a, b, c, d, e, f = ((0, n, 17) for n in (10, 11, 12, 13, 14, 15))
    graphs.step(a)
    step_a = graphs.step(a)
    graphs.step(b)
    graphs.step(c)
    assert graphs.keys() == [a, b, c]
    assert graphs.step(a) is step_a  # a is now the most recently used
    graphs.step(d)  # drops b, the least recently used
    assert graphs.keys() == [c, a, d] and len(graphs.keys()) == graphs.bound
    graphs.step(b)  # b is new again: eager, and it drops c
    assert graphs.keys() == [a, d, b] and graphs.captures == 1
    for key in (e, f):  # fed more distinct keys than the bound, it stays bounded
        assert graphs.step(key) is None and len(graphs.keys()) == graphs.bound
    assert graphs.keys() == [b, e, f]
    graphs.step(a)  # a was dropped with its step: seen once again, then captured anew
    assert isinstance(graphs.step(a), _Step) and graphs.step(a) is not step_a
    assert graphs.captures == 2
    # the default bound is the module's
    assert offline.ShapeGraphs().bound == offline.MAX_GRAPHS
