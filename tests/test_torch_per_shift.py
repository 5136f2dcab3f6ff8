"""The per-shift stream step of the PyTorch port (device="cpu") against the
JAX package's on the CPU: `make_step` at B=4 against
`jax.vmap(make_step(static))` with `state_batch_axes`, chunk by chunk, in
the unfused mode (band costs then the banded DP, natively on the CPU) and in
the K2 and K4 modes (the JAX vmap rule's Pallas kernel in interpret mode);
and the batched chunk's per-shift fallback against the JAX package's.

The wakeword is small (3 templates of 16-20 frames, C=8) and the streams play
its utterance at three offsets one MFCC shift apart, so that the fires land
on different shifts of a chunk and the in-chunk halt is exercised.

Detection decisions must be equal (fired, ww, counter); scores are compared
where an event fired at rtol 2e-5 / atol 2e-5, as in test_torch_batched.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpotter_tpu.ops.fused_dtw as jax_fd
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.runtime.state import init_state as jax_init_state
from rustpotter_tpu.runtime.state import state_batch_axes
from rustpotter_tpu.runtime.stream_step import make_step as jax_make_step
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.mfcc.averager import average_templates
from rustpotter_tpu_torch.mfcc.offline import mfcc_pipeline
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.convert import states_to_numpy
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_step
from rustpotter_tpu_torch.synthetic import correctness_stream
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

B = 4
C = 8
EV_TOL = dict(rtol=2e-5, atol=2e-5)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww",
               "partial_counter", "countdown", "vad_countdown", "rot", "gain", "gain_count")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level", "ext_buf")


def _chirps():
    """3 seeded chirp utterances of 20, 18 and 16 MFCC frames."""
    words = []
    for i in range(3):
        n = (20 - 2 * i + 3) * 160
        t = np.arange(n) / 16000.0
        rng = np.random.default_rng(200 + i)
        sig = 0.35 * np.sin(2 * np.pi * np.cumsum(300 + 1200 * t / t[-1]) / 16000.0)
        words.append((sig + 0.02 * rng.normal(size=n)).astype(np.float32))
    return words


@pytest.fixture(scope="module")
def small():
    """(the port's wakeword, JAX's copy of it, frames (T, B, 480)): streams
    0-2 play utterance 0 after 0, 160 and 320 samples of extra silence;
    stream 3 plays seeded noise."""
    words = _chirps()
    feats = {f"s{i}.wav": mfcc_pipeline(w, C + 1, "cpu") for i, w in enumerate(words)}
    avg = average_templates([feats[k] for k in sorted(feats)])
    ww = WakewordRef(name="chirp", samples_features=feats, avg_features=avg, rms_level=0.05)
    jww = JaxWakewordRef(name="chirp", samples_features=dict(feats), avg_features=avg,
                         rms_level=0.05)
    base = correctness_stream(20, words[0]).reshape(-1)
    rng = np.random.default_rng(9)
    T = len(base) // 480 - 1
    frames = rng.normal(0, 0.05, (T, B, 480)).astype(np.float32)
    for s in range(3):
        shifted = np.concatenate([np.zeros(160 * s, np.float32), base])
        frames[:, s] = shifted[: T * 480].reshape(T, 480)
    return ww, jww, frames


def _configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    return jcfg, cfg


def _jax_step_run(jww, frames, fused, jcfg=None):
    """Per-chunk events and states (numpy dicts, window as (F, C, B)) of the
    vmapped JAX per-shift step (config `jcfg`, default `_configs()[0]`)."""
    jcfg = _configs()[0] if jcfg is None else jcfg
    static, params = jax_build_bundle([("w", jww)], jcfg, dtw_fused=fused)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    axes = state_batch_axes()
    step = jax.jit(jax.vmap(jax_make_step(static), in_axes=(None, axes, 0), out_axes=(axes, 0)))
    states = jax_init_state(static, (B,))
    events, snaps = [], []
    for t in range(frames.shape[0]):
        states, ev = step(params, states, jnp.asarray(frames[t]))
        events.append({f: np.asarray(getattr(ev, f)) for f in ev._fields})
        snap = {f: np.asarray(getattr(states, f)) for f in states._fields}
        snap["win"] = np.transpose(snap["win"], (1, 2, 0))
        snaps.append(snap)
    return events, snaps


def _assert_event_equal(got, want, t):
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    fired = want["fired"]
    for f in ("score", "avg_score", "scores", "gain"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **EV_TOL,
                                   err_msg=f"chunk {t} {f}")


def _assert_state_equal(got, want, t):
    for f in EXACT_STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    for f in CLOSE_STATE:
        np.testing.assert_allclose(got[f], want[f], **EV_TOL, err_msg=f"chunk {t} {f}")
    np.testing.assert_allclose(got["win"], want["win"], **WIN_TOL, err_msg=f"chunk {t} win")
    np.testing.assert_array_equal(np.isnan(got["vad_win"]), np.isnan(want["vad_win"]))


def _port_step_run(ww, frames, events, snaps, dtw_fused, variant=3, cfg=None):
    """Runs the port's make_step on `frames` (config `cfg`, default
    `_configs()[1]`), comparing every chunk with the JAX run. Returns
    [(chunk, stream)] of every fire."""
    cfg = _configs()[1] if cfg is None else cfg
    static, params = build_bundle([("w", ww)], cfg, "cpu", dtw_fused=dtw_fused)
    static = dataclasses.replace(static, dtw_fused_variant=variant)
    step = make_step(static)
    states = init_state(static, B, "cpu")
    before = {**fd.LAUNCHES, **bd.LAUNCHES}
    fires = []
    for t in range(frames.shape[0]):
        states, ev = step(params, states, torch.tensor(frames[t]))
        got = events_to_numpy(ev)._asdict()
        _assert_event_equal(got, events[t], t)
        _assert_state_equal(states_to_numpy(states), snaps[t], t)
        fires += [(t, b) for b in np.nonzero(got["fired"])[0]]
    assert {**fd.LAUNCHES, **bd.LAUNCHES} == before  # the CPU runs plain versions
    return fires


def test_make_step_unfused_matches_jax_vmapped_step(small):
    ww, jww, frames = small
    events, snaps = _jax_step_run(jww, frames, fused=False)
    fires = _port_step_run(ww, frames, events, snaps, dtw_fused=False)
    # streams 0-2 fire, one MFCC shift apart: in at most 2 chunks, so at
    # least one fire lands before a chunk's last shift and halts the rest
    assert sorted(b for _, b in fires) == [0, 1, 2]
    assert len({t for t, _ in fires}) <= 2


def test_make_step_k2_matches_jax_vmapped_step_with_interpret_kernel(small, monkeypatch):
    """variant 3: the JAX vmap rule runs its Pallas kernel (_kernel_v3) in
    interpret mode; the port runs K2's plain version."""
    ww, jww, frames = small
    real = jax_fd.fused_dtw_batch_v3
    monkeypatch.setattr(jax_fd, "fused_dtw_batch_v3",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    events, snaps = _jax_step_run(jww, frames, fused=True)
    fires = _port_step_run(ww, frames, events, snaps, dtw_fused=True)
    assert sorted(b for _, b in fires) == [0, 1, 2]


def test_make_step_k4_matches_jax_vmapped_step_with_interpret_kernel(small, monkeypatch):
    """variant 2: the JAX vmap rule runs its Pallas kernel (_kernel_v2) in
    interpret mode on the rolled linear window; the port runs K4's plain
    version on the gathered one."""
    ww, jww, frames = small
    monkeypatch.setenv("RUSTPOTTER_FUSED_VARIANT", "2")
    real = jax_fd.fused_dtw_batch
    monkeypatch.setattr(jax_fd, "fused_dtw_batch",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    events, snaps = _jax_step_run(jww, frames, fused=True)
    fires = _port_step_run(ww, frames, events, snaps, dtw_fused=True, variant=2)
    assert sorted(b for _, b in fires) == [0, 1, 2]


def test_batched_chunk_fallback_matches_jax(small, monkeypatch):
    """dtw_fused False: the port's batched chunk scores each shift's virtual
    window through _dtw_scores, as the JAX package's fallback does."""
    ww, jww, frames = small
    monkeypatch.setenv("RUSTPOTTER_FUSED", "0")
    jdet = JaxBatchedDetector([("w", jww)], _configs()[0], batch_size=B)
    det = BatchedDetector([("w", ww)], _configs()[1], batch_size=B, device="cpu")
    assert det.static.dtw_fused is False and jdet.static.dtw_fused is False
    jstates, states = jdet.init_states(), det.init_states()
    before = {**fd.LAUNCHES, **bd.LAUNCHES}
    fired = 0
    for t in range(frames.shape[0]):
        jstates, jev = jdet.process_chunk(jdet.params, jstates, jnp.asarray(frames[t]))
        states, ev = det.process_chunk(det.params, states, frames[t])
        got = events_to_numpy(ev)._asdict()
        _assert_event_equal(got, {f: np.asarray(getattr(jev, f)) for f in jev._fields}, t)
        want = {f: np.asarray(getattr(jstates, f)) for f in jstates._fields}
        _assert_state_equal(states_to_numpy(states), want, t)
        fired += int(got["fired"].sum())
    assert fired == 3
    assert {**fd.LAUNCHES, **bd.LAUNCHES} == before


def test_make_step_with_the_gain_normalizer_matches_jax(small):
    """The config the port once refused: the gain normalizer on, unfused,
    against the vmapped JAX step (tests/test_torch_filters.py holds the
    band-pass and both filters)."""
    ww, jww, frames = small
    jcfg, cfg = _configs()
    jcfg.filters.gain_normalizer.enabled = cfg.filters.gain_normalizer.enabled = True
    events, snaps = _jax_step_run(jww, frames, fused=False, jcfg=jcfg)
    assert any((s["gain"] < 1.0).any() for s in snaps)  # the gain acted
    fires = _port_step_run(ww, frames, events, snaps, dtw_fused=False, cfg=cfg)
    assert sorted(b for _, b in fires) == [0, 1, 2]
