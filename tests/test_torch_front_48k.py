"""Input at 48 and 44.1 kHz through the PyTorch port against the JAX package
on the CPU: `BatchedDetector` and `make_step` with `in_graph_resample` (the
(B, 1440) or (B, 1323) chunk resampled by one fp32 GEMM), and `Rustpotter`
at 48 kHz int16 through the host encoder (the f32 rustfft oracle), on the
30-frame bench wakeword. Stream 0 plays the bench utterance synthesized at
the input rate with the same chirp law; the others play noise at the input
rate. Held as in test_torch_filters.py: decisions and the gain equal, scores
at rtol 2e-5 / atol 2e-5, states allclose (the resampler's overlap at the
score tolerance).
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu import AudioFmt as JaxAudioFmt
from rustpotter_tpu import SampleFormat as JaxSampleFormat
from rustpotter_tpu_torch import AudioFmt, SampleFormat
from rustpotter_tpu_torch.audio.resampler import chunk_sizes
from rustpotter_tpu_torch.synthetic import bench_utterances, correctness_stream
from test_torch_filters import (
    compare_batched,
    compare_rustpotter,
    compare_step,
    configs,
    ww_pair,
)

torch.set_num_threads(2)


def stream_at(rate: int, frames: int = 30) -> np.ndarray:
    """(T, n_in) chunks at `rate`: the correctness stream of the bench
    utterance synthesized at `rate`, cut into the resampler's input chunks."""
    utterance = bench_utterances(frames, rate)[0]
    return correctness_stream(frames, utterance, chunk_sizes(rate, 16000, 480)[0])


def fleet_at(rate: int, b: int = 4) -> np.ndarray:
    """(T, B, n_in): stream 0 the utterance, the others seeded noise."""
    s0 = stream_at(rate)
    frames = np.random.default_rng(rate).normal(0, 0.05, (s0.shape[0], b, s0.shape[1]))
    frames = frames.astype(np.float32)
    frames[:, 0] = s0
    return frames


def _formats(rate, fmt=SampleFormat.F32, jfmt=JaxSampleFormat.F32):
    return (JaxAudioFmt(sample_rate=rate, sample_format=jfmt),
            AudioFmt(sample_rate=rate, sample_format=fmt))


@pytest.fixture(scope="module")
def wakewords():
    ww, jww, _ = ww_pair()
    return ww, jww


@pytest.mark.parametrize("rate", [48000, 44100])
def test_batched_detector_in_graph_resample_matches_jax(wakewords, rate):
    ww, jww = wakewords
    frames = fleet_at(rate)
    assert frames.shape[2] == chunk_sizes(rate, 16000, 480)[0]
    ev = compare_batched(jww, ww, frames, *configs(fmt=_formats(rate)), in_graph_resample=True)
    assert ev["fired"][:, 0].sum() == 1 and ev["fired"][:, 1:].sum() == 0


def test_make_step_in_graph_resample_matches_jax(wakewords):
    ww, jww = wakewords
    assert compare_step(jww, ww, fleet_at(48000), *configs(fmt=_formats(48000)),
                        in_graph_resample=True) == 1


def test_rustpotter_at_48k_through_the_host_encoder_matches_jax(wakewords):
    """int16 frames of 1440 samples: the host encoder resamples each to 480
    (the f32 rustfft oracle and the identified table in both packages)."""
    ww, jww = wakewords
    frames = np.clip(np.round(stream_at(48000) * 32767.0), -32768, 32767).astype(np.int16)
    cfgs = configs(fmt=_formats(48000, SampleFormat.I16, JaxSampleFormat.I16))
    assert len(compare_rustpotter(jww, ww, frames, *cfgs)) == 1
