"""The single-stream `Rustpotter` of the PyTorch port (device="cpu") against
the JAX package's `Rustpotter` on the CPU, on the bench wakeword and the
audio of bench.correctness_pass, in each of the port's three DTW kernel
modes: K2 (the default), K4 (RUSTPOTTER_FUSED_VARIANT=2) and band costs then
K3 (RUSTPOTTER_FUSED=0). On CPU tensors each mode runs its kernel's plain
version. The audio is int16: even frames go in through process_samples,
odd frames through process_bytes.

Detections must be equal (frame, name, counter, gain); scores allclose at
rtol 2e-5 / atol 2e-5 (fp32 summation order differs: MFCC GEMMs, CMN means,
the fused cost band against the JAX scan path).
"""
import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu import AudioFmt as JaxAudioFmt
from rustpotter_tpu import Rustpotter as JaxRustpotter
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import SampleFormat as JaxSampleFormat
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu_torch import (
    AudioFmt,
    Rustpotter,
    RustpotterConfig,
    SampleFormat,
    ScoreMode,
)
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.synthetic import correctness_stream
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def configs():
    """(JAX config, the port's config): MAX mode, avg gate 0.2, int16 input."""
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    jcfg.fmt = JaxAudioFmt(sample_format=JaxSampleFormat.I16)
    cfg.fmt = AudioFmt(sample_format=SampleFormat.I16)
    return jcfg, cfg


@pytest.fixture(scope="module")
def workload():
    """(JAX bench wakeword, the port's copy, int16 frames (T, 480))."""
    jww, utterance = bench.build_bench_wakeword()
    ww = WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                     avg_features=jww.avg_features, rms_level=jww.rms_level)
    stream = correctness_stream(max(len(m) for m in jww.samples_features.values()), utterance)
    frames = np.clip(np.round(stream * 32767.0), -32768, 32767).astype(np.int16)
    return jww, ww, frames


def play(rp, frames):
    """[(frame index, detection)]: even frames as samples, odd as bytes."""
    out = []
    for i, frame in enumerate(frames):
        d = (rp.process_samples(frame) if i % 2 == 0
             else rp.process_bytes(frame.astype("<i2").tobytes()))
        if d is not None:
            out.append((i, d))
    return out


def assert_detections_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g.name, g.counter, g.gain) == (w.name, w.counter, w.gain)
        assert list(g.scores) == list(w.scores)
        np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                   [w.score, w.avg_score, *w.scores.values()], **TOL)


@pytest.fixture(scope="module")
def jax_detections(workload):
    jww, _, frames = workload
    jrp = JaxRustpotter(configs()[0])
    jrp.add_wakeword("w", jww)
    return play(jrp, frames)


@pytest.mark.parametrize("mode", ["k2", "k4", "k3"])
def test_rustpotter_matches_jax(workload, jax_detections, mode, monkeypatch):
    _, ww, frames = workload
    if mode == "k4":
        monkeypatch.setenv("RUSTPOTTER_FUSED_VARIANT", "2")
    if mode == "k3":
        monkeypatch.setenv("RUSTPOTTER_FUSED", "0")
    rp = Rustpotter(configs()[1], device="cpu")
    rp.add_wakeword("w", ww)
    st = rp._static
    assert (st.dtw_fused, st.dtw_fused_variant) == {
        "k2": (None, 3), "k4": (None, 2), "k3": (False, 3)}[mode]
    before = {**fd.LAUNCHES, **bd.LAUNCHES}
    got = play(rp, frames)
    assert {**fd.LAUNCHES, **bd.LAUNCHES} == before  # plain versions on the CPU
    assert len(jax_detections) == 1  # the utterance fires once
    assert_detections_equal(got, jax_detections)
