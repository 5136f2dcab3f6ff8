"""The single-stream `Rustpotter` of the PyTorch port (device="cpu") with an
NN wakeword, against the JAX package's `Rustpotter` on the CPU: `mixed`,
the bench DTW wakeword beside the firing MEDIUM classifier
(`synthetic.build_firing_nn_wakeword`), on the bench utterance's
correctness stream as int16 audio (even frames through process_samples,
odd frames through process_bytes). Both wakewords detect the utterance; the
NN one wins the best-candidate choice and names the detection by its
winning label.

Detections must be equal (frame, name, counter, gain, the score labels);
scores allclose at rtol 1e-4 / atol 1e-3 (the NN tolerance; measured max
|d| on the CPU 2.7e-5, on logits up to 40).
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
from rustpotter_tpu_torch import AudioFmt, Rustpotter, RustpotterConfig, SampleFormat, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.synthetic import build_firing_nn_wakeword, correctness_stream
from rustpotter_tpu_torch.wakewords.files import WakewordRef
from test_torch_nn import jax_model

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)


def configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    jcfg.fmt = JaxAudioFmt(sample_format=JaxSampleFormat.I16)
    cfg.fmt = AudioFmt(sample_format=SampleFormat.I16)
    return jcfg, cfg


def play(rp, frames):
    out = []
    for i, frame in enumerate(frames):
        d = (rp.process_samples(frame) if i % 2 == 0
             else rp.process_bytes(frame.astype("<i2").tobytes()))
        if d is not None:
            out.append((i, d))
    return out


@pytest.fixture(scope="module")
def mixed():
    """(port wakewords, JAX wakewords, int16 frames (T, 480))."""
    jww, utterance = bench.build_bench_wakeword()
    ww = WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                     avg_features=jww.avg_features, rms_level=jww.rms_level)
    m = build_firing_nn_wakeword(utterance, device="cpu")
    stream = correctness_stream(m.train_size, utterance)
    frames = np.clip(np.round(stream * 32767.0), -32768, 32767).astype(np.int16)
    return [("w", ww), ("n", m)], [("w", jww), ("n", jax_model(m))], frames


def test_rustpotter_mixed_matches_jax(mixed):
    wws, jwws, frames = mixed
    jrp = JaxRustpotter(configs()[0])
    rp = Rustpotter(configs()[1], device="cpu")
    for (k, w), (_, jw) in zip(wws, jwws):
        jrp.add_wakeword(k, jw)
        rp.add_wakeword(k, w)
    assert rp._static.names == ("w", "n") and rp._static.smax == 5
    want = play(jrp, frames)
    before = dict(fd.LAUNCHES)
    got = play(rp, frames)
    assert fd.LAUNCHES == before  # plain versions on the CPU
    assert len(want) == 1 and want[0][1].name == "bench"  # the NN label names it
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g.name, g.counter, g.gain) == (w.name, w.counter, w.gain)
        assert list(g.scores) == list(w.scores) == ["bench", "none"]
        np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                   [w.score, w.avg_score, *w.scores.values()], **TOL)
        assert g.score - 0.5 > 10 * (TOL["atol"] + TOL["rtol"] * g.score)
    # removing the NN wakeword leaves the DTW one, which names by its own name
    rp.remove_wakeword("n")
    rp.reset()
    got = play(rp, frames[:200])
    assert [d.name for _, d in got] == ["bench"] and len(got[0][1].scores) == 5
