"""The CUDA-graph wrapper of the PyTorch port (`runtime/graph.py`) and the
graphed entry points on the CPU, where they run eagerly: the CPU path calls
the eager step unchanged, and a sequence the calls in order in every
kernel mode; the capture key as a pure function; Events that stay as they
were after the next chunk; resets that keep every state tensor's storage; the steps reading
nothing on the host in any kernel mode (a capture cannot); and the port's
`process_sequence` and `process_audio_sequence` against the JAX package's
jitted `lax.scan` versions (`rustpotter_tpu/runtime/batch.py:211`,
`rustpotter_tpu/runtime/detector.py:112`). The graphs themselves run on the
card: tests/test_torch_graph_cuda.py.

Workload: the 30-frame bench wakeword at B = 4. Tolerances as in
test_torch_batched.py: events equal (fired, ww, counter), scores where an
event fired at rtol 2e-5 / atol 2e-5 (fp32 summation order differs between
the packages), states at 2e-5, the window's MFCC rows (up to ~30) at rtol
1e-5 / atol 1e-4. The port against itself: bit for bit.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import Rustpotter as JaxRustpotter
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import AudioFmt, Rustpotter, RustpotterConfig, SampleFormat, ScoreMode
from rustpotter_tpu_torch.runtime import graph
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.convert import states_to_numpy
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk, make_step
from rustpotter_tpu_torch.synthetic import (
    bench_utterances,
    build_bench_nn_wakeword,
    build_bench_wakeword,
    correctness_stream,
)

torch.set_num_threads(2)

B = 4
EV_TOL = dict(rtol=2e-5, atol=2e-5)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww", "partial_counter",
               "countdown", "vad_countdown", "rot")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level")


def configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    return jcfg, cfg


@pytest.fixture(scope="module")
def workload():
    """(the port's 30-frame bench wakeword, the JAX package's copy, frames
    (T, B, 480): stream 0 the utterance, the rest seeded noise)."""
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    jww = JaxWakewordRef(name=ww.name, samples_features=dict(ww.samples_features),
                         avg_features=ww.avg_features, rms_level=ww.rms_level)
    stream0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(7).normal(0, 0.05, (len(stream0), B, 480)).astype(np.float32)
    frames[:, 0] = stream0
    return ww, jww, frames


def same(a, b) -> bool:
    """Equal bits (a NaN equals the same NaN)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_cpu_path_calls_the_eager_step_unchanged(workload):
    ww, _, frames = workload
    det = BatchedDetector([("w", ww)], configs()[1], batch_size=B, device="cpu")
    calls = []

    def fn(params, states, x):
        calls.append((params, states, x))
        return "result"

    x = torch.tensor(frames[0])
    wrapped = graph.GraphedStep(fn)
    states = det.init_states()
    assert wrapped(det.params, states, x) == "result"
    assert calls == [(det.params, states, x)] and wrapped.captures == 0
    # the real chunk, wrapped and not, over a sequence and chunk by chunk
    eager = make_batched_chunk(det.static)
    s1, s2 = det.init_states(), det.init_states()
    s1, seq = graph.GraphedStep(make_batched_chunk(det.static)).sequence(
        det.params, s1, torch.tensor(frames[:6]))
    for t in range(6):
        s2, ev = eager(det.params, s2, torch.tensor(frames[t]))
        assert all(same(a[t], b) for a, b in zip(seq, ev)), t
    assert all(same(a, b) for a, b in zip(s1, s2))


def test_capture_key_changes_exactly_with_params_state_storage_and_shape(workload):
    ww, _, frames = workload
    det = BatchedDetector([("w", ww)], configs()[1], batch_size=B, device="cpu")
    states = det.init_states()
    x = torch.tensor(frames[0])
    key = graph.capture_key(det.params, states, x)
    # the same objects, other frame values, an in-place reset: the same graph
    assert graph.capture_key(det.params, states, x) == key
    assert graph.capture_key(det.params, states, torch.tensor(frames[5])) == key
    det.process_chunk(det.params, states, x)
    det.reset_streams(states, np.array([True, False, True, False]))
    assert graph.capture_key(det.params, states, x) == key
    # another parameter set, even an equal one
    assert graph.capture_key(dataclasses.replace(det.params), states, x) != key
    # other state storage: a second init_states(), one tensor replaced,
    # the fresh tensors of a migration
    assert graph.capture_key(det.params, det.init_states(), x) != key
    assert graph.capture_key(det.params, states._replace(gain=states.gain.clone()), x) != key
    migrated = det.update_detector_config(copy.deepcopy(det.config.detector), states)
    assert graph.capture_key(det.params, migrated, x) != key
    # the input's shape or dtype
    assert graph.capture_key(det.params, states, x[:3]) != key
    assert graph.capture_key(det.params, states, torch.zeros(B, 1440)) != key
    assert graph.capture_key(det.params, states, x.double()) != key


def test_an_event_is_unchanged_by_the_next_chunk(workload):
    ww, _, frames = workload
    det = BatchedDetector([("w", ww)], configs()[1], batch_size=B, device="cpu")
    states = det.init_states()
    kept = []
    for t in range(frames.shape[0]):
        states, ev = det.process_chunk(det.params, states, frames[t])
        kept.append((ev, [f.clone() for f in ev]))
    assert any(bool(ev.fired[0]) for ev, _ in kept)
    for ev, copies in kept:
        assert all(same(a, b) for a, b in zip(ev, copies))
    rp = Rustpotter(configs()[1], device="cpu")
    rp.add_wakeword_ref("w", ww)
    dets = []
    for t in range(frames.shape[0]):
        d = rp.process_audio(frames[t, 0])
        if d is not None:
            dets.append((d, copy.deepcopy(d)))
    assert dets
    assert all(d == c for d, c in dets)


def test_resets_keep_every_state_tensors_storage(workload):
    ww, _, frames = workload
    det = BatchedDetector([("w", ww)], configs()[1], batch_size=B, device="cpu")
    states = det.init_states()
    for t in range(40):
        states, _ = det.process_chunk(det.params, states, frames[t])
    ptrs = [t.data_ptr() for t in states]
    mask = np.array([True, False, False, True])
    back = det.reset_streams(states, mask)
    assert back is states and [t.data_ptr() for t in states] == ptrs
    fresh = det.init_states()
    for f in ("partial_active", "countdown", "win_count", "ext_count", "gain"):
        assert torch.equal(getattr(states, f)[mask], getattr(fresh, f)[mask]), f

    rp = Rustpotter(configs()[1], device="cpu")
    rp.add_wakeword_ref("w", ww)
    for t in range(40):
        rp.process_audio(frames[t, 0])
    st = rp._state
    ptrs = [t.data_ptr() for t in st]
    rp.reset()
    assert rp._state is st and [t.data_ptr() for t in st] == ptrs
    for a, b in zip(st, init_state(rp._static, 1, "cpu")):
        assert same(a, b)


def _assert_events(got, want, what):
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")
    fired = want["fired"]
    for f in ("score", "avg_score", "scores", "gain"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **EV_TOL,
                                   err_msg=f"{what} {f}")


def test_process_sequence_matches_the_jax_scan(workload):
    ww, jww, frames = workload
    jcfg, cfg = configs()
    jdet = JaxBatchedDetector([("w", jww)], jcfg, batch_size=B)
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device="cpu")
    jst, jev = jdet.process_sequence(jdet.params, jdet.init_states(), jnp.asarray(frames))
    st, ev = det.process_sequence(det.params, det.init_states(), frames)
    want = {f: np.asarray(getattr(jev, f)) for f in jev._fields}
    got = events_to_numpy(ev)._asdict()
    assert got["fired"].shape == (frames.shape[0], B) and want["fired"][:, 0].any()
    _assert_events(got, want, "process_sequence")
    got_st, want_st = states_to_numpy(st), {f: np.asarray(getattr(jst, f)) for f in jst._fields}
    for f in EXACT_STATE:
        np.testing.assert_array_equal(got_st[f], want_st[f], err_msg=f)
    for f in CLOSE_STATE:
        np.testing.assert_allclose(got_st[f], want_st[f], **EV_TOL, err_msg=f)
    np.testing.assert_allclose(got_st["win"], want_st["win"], **WIN_TOL)


def test_process_audio_sequence_matches_the_jax_scan(workload):
    ww, jww, frames = workload
    jcfg, cfg = configs()
    jrp, rp = JaxRustpotter(jcfg), Rustpotter(cfg, device="cpu")
    jrp.add_wakeword_ref("w", jww)
    rp.add_wakeword_ref("w", ww)
    audio = frames[:, 0].reshape(-1)
    want, got = jrp.process_audio_sequence(audio), rp.process_audio_sequence(audio)
    assert len(want) == len(got) >= 1
    for g, w in zip(got, want):
        assert (g.name, g.counter, list(g.scores)) == (w.name, w.counter, list(w.scores))
        np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                   [w.score, w.avg_score, *w.scores.values()], **EV_TOL)
    # the same state after it: the frame loop continues where the scan ended
    assert rp.get_rms_level() == pytest.approx(jrp.get_rms_level(), rel=1e-5, abs=1e-7)


def _mode(kind, ww):
    """(step, static, params, frames (T, B, n)) of one kernel mode or front-end."""
    cfg = configs()[1]
    bundle = {}
    words = [("w", ww)]
    if kind.endswith("filtered"):
        cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = True
    if kind.endswith("48k"):
        cfg.fmt = AudioFmt(sample_rate=48000, sample_format=SampleFormat.F32)
        bundle["in_graph_resample"] = True
    if kind.endswith("nn"):
        words = [("w", ww), ("n", build_bench_nn_wakeword())]
    if "K3" in kind:
        bundle["dtw_fused"] = False
    static, params = build_bundle(words, cfg, "cpu", **bundle)
    if "K4" in kind:
        static = dataclasses.replace(static, dtw_fused_variant=2)
    n = static.input_samples
    frames = np.random.default_rng(3).normal(0, 0.05, (3, B, n)).astype(np.float32)
    if n == 480:
        utterance = bench_utterances(30)[0]
    else:
        utterance = bench_utterances(30, 48000)[0]
    frames[:, 0] = correctness_stream(30, utterance, n)[: 3]
    make = make_batched_chunk if kind.startswith("chunk") else make_step
    return make(static), static, params, frames


MODES = ["chunk-K1", "chunk-K4", "chunk-K3", "chunk-filtered", "chunk-48k", "chunk-nn",
         "step-K2", "step-K4", "step-K3", "step-filtered", "step-48k", "step-nn"]


@pytest.mark.parametrize("kind", MODES)
def test_steps_read_nothing_on_the_host(workload, kind, monkeypatch):
    """What a capture cannot hold: no Tensor.item, tolist, numpy, or
    conversion of a tensor to a Python bool, int or float, in any kernel mode
    (K1, K4, band costs + K3; K2 per shift), with the filters, at 48 kHz, and
    with an NN wakeword. The first call builds the parameter set's
    constants."""
    fn, static, params, frames = _mode(kind, workload[0])
    states = init_state(static, B, "cpu")
    fn(params, states, torch.tensor(frames[0]))

    def host_read(self, *args, **kwargs):
        raise AssertionError("a host read inside the step")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for t in (1, 2):
        fn(params, states, torch.tensor(frames[t]))
    with pytest.raises(AssertionError, match="host read"):
        bool(states.rot == 0)


@pytest.mark.parametrize("kind", ["chunk-K1", "chunk-K3", "chunk-filtered", "step-K2",
                                  "step-K4", "step-nn"])
def test_a_sequence_on_the_cpu_is_the_calls_in_order(workload, kind):
    """`GraphedStep.sequence` on CPU tensors: the eager step over the inputs
    in order, its Events stacked bit for bit, nothing captured."""
    fn, static, params, frames = _mode(kind, workload[0])
    wrapped = graph.GraphedStep(fn)
    s1, s2 = init_state(static, B, "cpu"), init_state(static, B, "cpu")
    s1, seq = wrapped.sequence(params, s1, torch.tensor(frames))
    for t in range(frames.shape[0]):
        s2, ev = fn(params, s2, torch.tensor(frames[t]))
        assert all(same(a[t], b) for a, b in zip(seq, ev)), (kind, t)
    assert all(same(a, b) for a, b in zip(s1, s2)) and wrapped.captures == 0
