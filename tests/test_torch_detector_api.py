"""The rest of the single-stream API of the PyTorch port against the JAX
package on the CPU: the wakeword lifecycle (add, a refused add, remove),
reset, update_config, the record feature and process_audio_sequence of
`Rustpotter`; the wakeword builder from WAV files and buffers; the audio
encoder and the WAV reader and writer. Same workload and tolerances as
test_torch_detector.py.
"""
import os

import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu import AudioFmt as JaxAudioFmt
from rustpotter_tpu import Rustpotter as JaxRustpotter
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import SampleFormat as JaxSampleFormat
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu import build_wakeword_ref_from_buffers as jax_from_buffers
from rustpotter_tpu import build_wakeword_ref_from_files as jax_from_files
from rustpotter_tpu.audio.encoder import AudioEncoder as JaxAudioEncoder
from rustpotter_tpu.audio.encoder import decode_bytes as jax_decode_bytes
from rustpotter_tpu.mfcc.offline import compute_mfccs as jax_compute_mfccs
from rustpotter_tpu.config import Endianness as JaxEndianness
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import (
    AudioFmt,
    Endianness,
    Rustpotter,
    RustpotterConfig,
    SampleFormat,
    ScoreMode,
    build_wakeword_ref_from_buffers,
    build_wakeword_ref_from_files,
)
from rustpotter_tpu_torch.audio.encoder import AudioEncoder, decode_bytes
from rustpotter_tpu_torch.mfcc.offline import compute_mfccs
from rustpotter_tpu_torch.synthetic import bench_utterances, correctness_stream
from rustpotter_tpu_torch.utils.wav import read_wav, write_wav
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _configs(**detector):
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    jcfg.fmt = JaxAudioFmt(sample_format=JaxSampleFormat.I16)
    cfg.fmt = AudioFmt(sample_format=SampleFormat.I16)
    for k, v in detector.items():
        setattr(jcfg.detector, k, v)
        setattr(cfg.detector, k, v)
    return jcfg, cfg


@pytest.fixture(scope="module")
def workload():
    jww, utterance = bench.build_bench_wakeword()
    ww = WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                     avg_features=jww.avg_features, rms_level=jww.rms_level)
    stream = correctness_stream(max(len(m) for m in jww.samples_features.values()), utterance)
    frames = np.clip(np.round(stream * 32767.0), -32768, 32767).astype(np.int16)
    return jww, ww, frames


def _detections(rp, frames):
    return [(i, d) for i, d in enumerate(map(rp.process_samples, frames)) if d is not None]


def _assert_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g.name, g.counter, g.gain, list(g.scores)) == (w.name, w.counter, w.gain,
                                                               list(w.scores))
        np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                   [w.score, w.avg_score, *w.scores.values()], **TOL)


def test_lifecycle_reset_update_config_and_record_match_jax(workload, tmp_path):
    jww, ww, frames = workload
    jcfg, cfg = _configs()
    jrp, rp = JaxRustpotter(jcfg), Rustpotter(cfg, device="cpu")
    assert rp.process_samples(frames[0]) is None  # no wakeword yet
    assert (rp.get_samples_per_frame(), rp.get_bytes_per_frame()) == (480, 960)
    jrp.add_wakeword_ref("w", jww)
    rp.add_wakeword_ref("w", ww)
    # a wakeword of another MFCC size is refused and leaves the set as it was
    other = WakewordRef(name="o", samples_features={"a": np.ones((20, 8), np.float32)},
                        rms_level=0.05)
    with pytest.raises(ValueError):
        rp.add_wakeword_ref("o", other)
    assert [k for k, _ in rp.wakewords] == ["w"]
    # a partial stretch, then reset: the next run starts from a fresh state
    for r in (jrp, rp):
        _detections(r, frames[:30])
    assert rp.get_rms_level() == pytest.approx(jrp.get_rms_level(), rel=1e-5, abs=1e-7)
    assert rp.get_gain() == jrp.get_gain() == 1.0
    jrp.reset()
    rp.reset()
    # update_config: AVERAGE mode and recording of improving partials
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jcfg2, _ = _configs(score_mode=JaxScoreMode.AVERAGE, record_path=str(jdir))
    _, cfg2 = _configs(score_mode=ScoreMode.AVERAGE, record_path=str(pdir))
    jrp.update_config(jcfg2)
    rp.update_config(cfg2)
    want = _detections(jrp, frames)
    got = _detections(rp, frames)
    assert len(want) == 1
    _assert_equal(got, want)
    assert rp.get_partial_detection() is None and jrp.get_partial_detection() is None
    jrec, prec = sorted(os.listdir(jdir)), sorted(os.listdir(pdir))
    assert len(prec) == len(jrec) >= 1
    for name in prec:
        assert name.startswith("[w]") and name.endswith(".wav")
        samples, spec = read_wav(str(pdir / name))
        assert spec.sample_rate == 16000 and spec.is_float
        assert 0 < len(samples) <= (rp._static.max_mfcc_frames // 3) * 480
    # removal
    assert rp.remove_wakeword("w") and not rp.remove_wakeword("w")
    assert rp.process_samples(frames[0]) is None and not rp.remove_wakewords()


def test_default_device_is_cuda_and_never_falls_back(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Rustpotter(_configs()[1])


def test_process_audio_sequence_matches_jax(workload):
    jww, ww, frames = workload
    jcfg, cfg = _configs()
    jrp, rp = JaxRustpotter(jcfg), Rustpotter(cfg, device="cpu")
    jrp.add_wakeword_ref("w", jww)
    rp.add_wakeword_ref("w", ww)
    audio = frames.reshape(-1).astype(np.float32) / np.float32(32767.0)
    want = jrp.process_audio_sequence(audio)
    got = rp.process_audio_sequence(audio)
    assert len(want) == 1
    _assert_equal(list(enumerate(got)), list(enumerate(want)))


@pytest.mark.parametrize("fmt", ["f32", "i16"])
def test_wakeword_builder_matches_jax(tmp_path, fmt):
    """build_wakeword_ref_from_files / _from_buffers against the JAX
    builder on WAV files of the bench utterances."""
    paths = []
    for i, w in enumerate(bench_utterances()[:3]):
        p = str(tmp_path / f"u{i}.wav")
        data = w if fmt == "f32" else np.round(w * 32767.0).astype(np.int16)
        write_wav(p, data, 16000)
        paths.append(p)
    want = jax_from_files("u", paths, mfcc_size=16)
    got = build_wakeword_ref_from_files("u", paths, mfcc_size=16, device="cpu")
    buffers = {os.path.basename(p): open(p, "rb").read() for p in paths}
    got_b = build_wakeword_ref_from_buffers("u", buffers, mfcc_size=16, device="cpu")
    want_b = jax_from_buffers("u", buffers, mfcc_size=16)
    for g, w in ((got, want), (got_b, want_b)):
        assert isinstance(w, JaxWakewordRef) and list(g.samples_features) == list(w.samples_features)
        for k in w.samples_features:
            np.testing.assert_allclose(g.samples_features[k], w.samples_features[k],
                                       rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(g.avg_features, w.avg_features, rtol=1e-4, atol=2e-4)
        assert g.rms_level == pytest.approx(w.rms_level, rel=1e-6)
    with pytest.raises(FileNotFoundError):
        build_wakeword_ref_from_files("u", [str(tmp_path / "missing.wav")], device="cpu")


def test_encoder_and_wav_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.integers(-32768, 32768, 960).astype("<i2")
    for e, je in ((Endianness.LITTLE, JaxEndianness.LITTLE), (Endianness.BIG, JaxEndianness.BIG)):
        np.testing.assert_array_equal(decode_bytes(x.tobytes(), SampleFormat.I16, e),
                                      jax_decode_bytes(x.tobytes(), JaxSampleFormat.I16, je))
    enc = AudioEncoder(AudioFmt(sample_format=SampleFormat.I16, channels=2))
    assert (enc.get_input_frame_length(), enc.get_output_frame_length()) == (960, 480)
    np.testing.assert_array_equal(enc.rencode_and_resample(x),
                                  x[::2].astype(np.float32) / np.float32(32767.0))
    enc48 = AudioEncoder(AudioFmt(sample_rate=48000))
    jenc48 = JaxAudioEncoder(JaxAudioFmt(sample_rate=48000))
    assert (enc48.get_input_frame_length(), enc48.get_output_frame_length()) == (1440, 480)
    y = rng.normal(0, 0.3, 1440).astype(np.float32)
    np.testing.assert_array_equal(enc48.rencode_and_resample(y), jenc48.rencode_and_resample(y))
    rp48 = Rustpotter(RustpotterConfig(fmt=AudioFmt(sample_rate=48000)), device="cpu")
    jrp48 = JaxRustpotter(JaxConfig(fmt=JaxAudioFmt(sample_rate=48000)))
    assert rp48.get_samples_per_frame() == jrp48.get_samples_per_frame() == 1440
    p = str(tmp_path / "x.wav")
    write_wav(p, x.astype(np.int16), 48000)
    samples, spec = read_wav(p)
    np.testing.assert_array_equal(samples, x)
    assert (spec.sample_rate, spec.channels, spec.bits_per_sample, spec.is_float) == (
        48000, 1, 16, False)
    words48 = np.concatenate([np.repeat(w, 3) for w in bench_utterances(30)[:2]])
    p48 = str(tmp_path / "u48.wav")
    write_wav(p48, np.round(words48 * 32767.0).astype(np.int16), 48000)
    got, rms = compute_mfccs(p48, 16, device="cpu")
    want, jrms = jax_compute_mfccs(p48, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    assert rms == pytest.approx(jrms, rel=1e-6)
    with pytest.raises(ValueError, match="RIFF"):
        read_wav(b"not a wav file")
