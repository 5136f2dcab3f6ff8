"""The audio filters of the PyTorch port against the JAX package's on the CPU.

Units: the port's host filter classes and the biquad's plain version against
the JAX package's host classes and scan; the gain normalizer and band-pass of
`prepare_chunk` against the host oracles, chunk after chunk. End to end:
`BatchedDetector`, `make_step` and `Rustpotter` (device="cpu") against the
JAX package's with the gain normalizer, the band-pass, and both, on the
30-frame bench wakeword at B = 4.

Tolerances: the biquad's plain version equals the host `BandPassFilter` bit
for bit (both round every product and sum to fp32). The JAX package's CPU
scan contracts four of the five products into FMAs (pinned below by a numpy
emulation of that order), so its output differs from the oracle's by up to
~2e-6 of the frame's peak at the default 80-400 Hz band: the taps `bp` are
held to it at atol 1e-5. Detection decisions (fired, ww, counter) and the
gain must be equal; scores where an event fired at rtol 2e-5 / atol 2e-5, as
in test_torch_batched.py.

The gain's step: the host classes (both packages' `GainNormalizerFilter`,
as the reference) divide, floor(g·10 + 0.5) / 10, and give 0.9 at k = 9;
both packages' stream steps multiply by fl32(0.1) (the JAX package's
division by a constant compiles to that product; the port writes it,
`ops.biquad.GAIN_STEP`) and give 0.90000004 (0x3F666667) there. The step's
gain is held to the JAX package's bit for bit, at a stream that reaches 0.9
(noise at 0.062 on the 30-frame bench wakeword) and over every step k.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import Rustpotter as JaxRustpotter
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.audio import filters as jax_filters
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.runtime.state import init_state as jax_init_state
from rustpotter_tpu.runtime.state import state_batch_axes
from rustpotter_tpu.runtime.stream_step import make_step as jax_make_step
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import Rustpotter, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.audio import filters
from rustpotter_tpu_torch.ops import biquad, frontend
from rustpotter_tpu_torch.ops.biquad import GAIN_STEP
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.convert import states_to_numpy
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_step, prepare_chunk
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

torch.set_num_threads(2)

B = 4
EV_TOL = dict(rtol=2e-5, atol=2e-5)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
BP_TOL = dict(rtol=0, atol=1e-5)  # JAX's FMA-contracted scan, see the docstring
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww", "partial_counter",
               "countdown", "vad_countdown", "rot", "gain", "gain_count")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level", "gain_win",
               "rs_overlap")
STATIC_FIELDS = ("input_samples", "input_rate", "gain_enabled", "gain_min", "gain_max",
                 "gain_window_size", "bp_enabled", "bp_coeffs")
FILTERS = {"gain": (True, False), "band_pass": (False, True), "both": (True, True)}
LEVEL_09 = 0.062  # stream 1's noise level that gives gain 0.9 (k = 9)
GAIN_09 = np.float32(9) * np.float32(0.1)  # the steps' gain there, 0x3F666667
LEAD = 12  # Rustpotter's lead of stream-1 chunks: more than the gain window (10)
# the end-to-end cases: (filters, stream 1's noise level); the ones at 0.05
# (gain 1) keep the filters' names as ids
CASES = ([pytest.param(w, 0.05, id=w) for w in FILTERS]
         + [pytest.param(w, LEVEL_09, id=f"{w}-gain0.9") for w in ("gain", "both")])
CUTOFFS = ((80.0, 400.0), (200.0, 1300.0))


def configs(what=None, fmt=None):
    """(JAX config, the port's): MAX mode, avg gate 0.2, the filters of
    FILTERS[what] (none for None), input format `fmt` = (JAX's, the port's)."""
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    gain, bp = FILTERS[what] if what else (False, False)
    for c in (jcfg, cfg):
        c.detector.avg_threshold = 0.2
        c.filters.gain_normalizer.enabled = gain
        c.filters.band_pass.enabled = bp
    if fmt is not None:
        jcfg.fmt, cfg.fmt = fmt
    return jcfg, cfg


def ww_pair(longest=30):
    """(the port's 30-frame bench wakeword, the JAX package's copy, utterance)."""
    ww, utterance = build_bench_wakeword(device="cpu", longest=longest)
    jww = JaxWakewordRef(name=ww.name, samples_features=dict(ww.samples_features),
                         avg_features=ww.avg_features, rms_level=ww.rms_level)
    return ww, jww, utterance


def level_streams(stream0: np.ndarray, seed: int, floor: float = 1e-3,
                  level1: float = 0.05) -> np.ndarray:
    """(T, 4, n) chunks: stream 0 `stream0` (the utterance) on a noise floor
    at `floor` (a microphone's; `test_band_pass_ring_down_after_digital_silence`
    takes exact silence), 1 noise at `level1` (0.05: gain 1; LEVEL_09: gain
    0.9), 2 noise at 0.2 (gain 0.5), 3 one impulse of 3.0 per chunk on noise
    at 0.01 (gain 0.6, the scaled impulse clipped at 1)."""
    T, n = stream0.shape
    rng = np.random.default_rng(seed)
    frames = np.empty((T, 4, n), np.float32)
    frames[:, 0] = stream0 + rng.normal(0, floor, (T, n))
    frames[:, 1] = rng.normal(0, level1, (T, n))
    frames[:, 2] = rng.normal(0, 0.2, (T, n))
    frames[:, 3] = rng.normal(0, 0.01, (T, n))
    frames[np.arange(T), 3, rng.integers(0, n, T)] = 3.0
    return frames


@pytest.fixture(scope="module")
def workload():
    ww, jww, utterance = ww_pair()
    stream0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    return ww, jww, stream0


def frames_at(workload, level1):
    ww, jww, stream0 = workload
    return ww, jww, level_streams(stream0, 5, level1=level1)


def _numpy(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def assert_event_equal(got, want, t):
    for f in ("fired", "ww", "counter", "gain"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    fired = want["fired"]
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **EV_TOL,
                                   err_msg=f"chunk {t} {f}")


def assert_state_equal(got, want, t):
    for f in EXACT_STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    for f in CLOSE_STATE:
        np.testing.assert_allclose(got[f], want[f], **EV_TOL, err_msg=f"chunk {t} {f}")
    np.testing.assert_allclose(got["bp"], want["bp"], **BP_TOL, err_msg=f"chunk {t} bp")
    np.testing.assert_allclose(got["win"], want["win"], **WIN_TOL, err_msg=f"chunk {t} win")
    np.testing.assert_array_equal(np.isnan(got["vad_win"]), np.isnan(want["vad_win"]))


def compare_batched(jww, ww, frames, jcfg, cfg, in_graph_resample=False, seen=None):
    """The JAX and the port's BatchedDetector chunk by chunk on `frames`:
    events and states held after every chunk; the state's gains go into the
    set `seen`, if given. Returns the port's events."""
    jdet = JaxBatchedDetector([("w", jww)], jcfg, batch_size=frames.shape[1],
                              in_graph_resample=in_graph_resample)
    det = BatchedDetector([("w", ww)], cfg, batch_size=frames.shape[1], device="cpu",
                          in_graph_resample=in_graph_resample)
    for f in STATIC_FIELDS:
        assert getattr(det.static, f) == getattr(jdet.static, f), f
    jst, st = jdet.init_states(), det.init_states()
    evs = []
    for t in range(frames.shape[0]):
        jst, jev = jdet.process_chunk(jdet.params, jst, jnp.asarray(frames[t]))
        st, ev = det.process_chunk(det.params, st, frames[t])
        got = events_to_numpy(ev)._asdict()
        assert_event_equal(got, _numpy(jev), t)
        assert_state_equal(states_to_numpy(st), _numpy(jst), t)
        if seen is not None:
            seen.update(st.gain.numpy().tolist())
        evs.append(got)
    return {f: np.stack([e[f] for e in evs]) for f in evs[0]}


def compare_step(jww, ww, frames, jcfg, cfg, in_graph_resample=False, seen=None):
    """The vmapped JAX per-shift step and the port's make_step, unfused (the
    front-end does not depend on the DTW kernel), chunk by chunk; the state's
    gains go into the set `seen`, if given. Returns stream 0's fires."""
    jstatic, jparams = jax_build_bundle([("w", jww)], jcfg, dtw_fused=False,
                                        in_graph_resample=in_graph_resample)
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    axes = state_batch_axes()
    jstep = jax.jit(jax.vmap(jax_make_step(jstatic), in_axes=(None, axes, 0),
                             out_axes=(axes, 0)))
    static, params = build_bundle([("w", ww)], cfg, "cpu", dtw_fused=False,
                                  in_graph_resample=in_graph_resample)
    for f in STATIC_FIELDS:
        assert getattr(static, f) == getattr(jstatic, f), f
    step = make_step(static)
    b = frames.shape[1]
    jst, st = jax_init_state(jstatic, (b,)), init_state(static, b, "cpu")
    fired = 0
    for t in range(frames.shape[0]):
        jst, jev = jstep(jparams, jst, jnp.asarray(frames[t]))
        st, ev = step(params, st, torch.tensor(frames[t]))
        got = events_to_numpy(ev)._asdict()
        assert_event_equal(got, _numpy(jev), t)
        want = _numpy(jst)
        want["win"] = np.transpose(want["win"], (1, 2, 0))
        assert_state_equal(states_to_numpy(st), want, t)
        if seen is not None:
            seen.update(st.gain.numpy().tolist())
        fired += int(got["fired"][0])
    return fired


def compare_rustpotter(jww, ww, frames, jcfg, cfg, seen=None):
    """The JAX and the port's Rustpotter frame by frame through
    process_samples: detections (frame, name, counter, gain) equal, scores
    close, and the gain and rms getters after every frame (the gains into
    the set `seen`, if given). Returns the detection frames."""
    jrp, rp = JaxRustpotter(jcfg), Rustpotter(cfg, device="cpu")
    jrp.add_wakeword_ref("w", jww)
    rp.add_wakeword_ref("w", ww)
    assert rp.get_rms_level_ref() == pytest.approx(jrp.get_rms_level_ref(), rel=1e-7)
    fires = []
    for i, frame in enumerate(frames):
        g, w = rp.process_samples(frame), jrp.process_samples(frame)
        assert (g is None) == (w is None), i
        assert rp.get_gain() == jrp.get_gain(), i
        if seen is not None:
            seen.add(rp.get_gain())
        assert rp.get_rms_level() == pytest.approx(jrp.get_rms_level(), rel=2e-5, abs=1e-7), i
        if w is not None:
            assert (g.name, g.counter, g.gain, list(g.scores)) == (
                w.name, w.counter, w.gain, list(w.scores)), i
            np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                       [w.score, w.avg_score, *w.scores.values()], **EV_TOL)
            fires.append(i)
    return fires


# ----------------------------------------------------------------- units

@pytest.mark.parametrize("cutoffs", CUTOFFS, ids=lambda c: f"{c[0]:.0f}-{c[1]:.0f}")
def test_band_pass_step_plain_equals_host_filter(cutoffs):
    """Three chunks with carried taps: the plain biquad, the port's and the
    JAX package's host BandPassFilter, bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.3, (3, 5, 480)).astype(np.float32)
    coeffs = filters.band_pass_coefficients(16000.0, *cutoffs)
    assert coeffs == jax_filters.band_pass_coefficients(16000.0, *cutoffs)
    mine = [filters.BandPassFilter(16000, *cutoffs) for _ in range(5)]
    theirs = [jax_filters.BandPassFilter(16000, *cutoffs) for _ in range(5)]
    state = torch.zeros(5, 4)
    for c in range(3):
        state, out = filters.band_pass_step(coeffs, state, torch.tensor(x[c]))
        want = np.stack([f.filter(x[c, b]) for b, f in enumerate(mine)])
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(
            want, np.stack([f.filter(x[c, b]) for b, f in enumerate(theirs)]))
        taps = np.array([[f.x1, f.x2, f.y1, f.y2] for f in mine], np.float32)
        np.testing.assert_array_equal(state.numpy(), taps)
    assert biquad.LAUNCHES["biquad"] == 0  # CPU tensors take the plain version


def test_jax_scan_is_the_fma_contracted_biquad():
    """The JAX package's CPU scan equals, bit for bit, y = fma(-b2, y2,
    fma(-b1, y1, fma(a2, x2, fma(a0, x, a1*x1)))) (an exact fp32 product in
    f64, one rounding per FMA); the port's plain version rounds every product
    and sum, so the two differ in the last bits and the IIR carries the
    difference on. Its size at the default band: under 1e-5 absolute on
    N(0, 0.3) frames, i.e. ~2e-6 of the frame's peak."""
    f32, f64 = np.float32, np.float64
    fma = lambda a, b, c: f32(f64(a) * f64(b) + f64(c))
    coeffs = filters.band_pass_coefficients(16000.0, 80.0, 400.0)
    a0, a1, a2, b1, b2 = coeffs
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.3, (3, 480)).astype(np.float32)
    jstate, jout = jax.jit(lambda s, v: jax_filters.band_pass_step(coeffs, s, v))(
        jnp.zeros((3, 4)), jnp.asarray(x))
    emu = np.empty_like(x)
    for b in range(3):
        x1 = x2 = y1 = y2 = f32(0)
        for i, v in enumerate(x[b]):
            y = fma(-b2, y2, fma(-b1, y1, fma(a2, x2, fma(a0, v, f32(a1 * x1)))))
            x2, x1, y2, y1 = x1, v, y1, y
            emu[b, i] = y
    np.testing.assert_array_equal(np.asarray(jout), emu)
    state, out = filters.band_pass_step(coeffs, torch.zeros(3, 4), torch.tensor(x))
    gap = np.abs(out.numpy() - emu).max()
    assert 0 < gap <= BP_TOL["atol"], gap
    assert gap <= 5e-6 * np.abs(emu).max(), (gap, np.abs(emu).max())
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **BP_TOL)


@pytest.mark.parametrize("fixed", [None, 0.04])
@pytest.mark.parametrize("window", [1, 3, 10])
def test_gain_normalizer_host_class_equals_jax(fixed, window):
    rng = np.random.default_rng(window)
    mine = filters.GainNormalizerFilter(0.1, 1.0, fixed)
    theirs = jax_filters.GainNormalizerFilter(0.1, 1.0, fixed)
    for f in (mine, theirs):
        f.set_rms_level_ref(0.05, window)
    for i in range(25):
        sig = rng.normal(0, rng.choice([0.0, 0.01, 0.05, 0.3, 2.0]), 480).astype(np.float32)
        rms = filters.GainNormalizerFilter.get_rms_level(sig)
        assert rms == jax_filters.GainNormalizerFilter.get_rms_level(sig)
        out, gain = mine.filter(sig, rms)
        jout, jgain = theirs.filter(sig, rms)
        assert gain == jgain, i
        np.testing.assert_array_equal(out, jout)


def step_gain(host_gain) -> np.float32:
    """The stream steps' gain where the host class gives `host_gain` = k/10
    (fl32(k · fl32(0.1)); see the module docstring), clamped as it is."""
    k = np.float32(np.round(np.float32(host_gain) * np.float32(10)))
    return np.float32(k * np.float32(0.1)) if host_gain != 1.0 else np.float32(1.0)


@pytest.mark.parametrize("level0", [0.3, LEVEL_09], ids=["noise0.3", "gain0.9"])
def test_prepare_chunk_filters_equal_the_host_oracles(level0):
    """The gain normalizer and band-pass of prepare_chunk, over 12 chunks of
    streams at four levels (stream 0 at noise `level0`: LEVEL_09 gives gain
    0.9; the others gains 1, 0.5 and 0.6), against one GainNormalizerFilter
    (fed the chunk's rms) and one BandPassFilter per stream: gains, taps and
    the pre-emphasized shifts bit for bit, with the steps' gain where the
    host class divides (0.9 at k = 9) and the samples scaled by it."""
    _, cfg = configs("both")
    ww, _, _ = ww_pair()
    static, params = build_bundle([("w", ww)], cfg, "cpu")
    frames = level_streams(np.zeros((12, 480), np.float32), 3)
    frames[:, 0] = np.random.default_rng(4).normal(0, level0, (12, 480))
    st = init_state(static, 4, "cpu")
    gains = [filters.GainNormalizerFilter(static.gain_min, static.gain_max) for _ in range(4)]
    bps = [filters.BandPassFilter(16000, 80.0, 400.0) for _ in range(4)]
    for g in gains:
        g.set_rms_level_ref(ww.rms_level, static.gain_window_size)
    seen = set()
    for t in range(frames.shape[0]):
        st, shifts = prepare_chunk(static, params, st, torch.tensor(frames[t]))
        rms = st.rms_level.numpy()
        want = []
        for b in range(4):
            _, host = gains[b].filter(frames[t, b], rms[b])
            gain = step_gain(host)
            assert st.gain[b].item() == gain, (t, b)
            seen.add(gain)
            sig = frames[t, b] if gain == 1.0 else np.clip(frames[t, b] * gain, -1.0, 1.0)
            want.append(bps[b].filter(sig))
        pre = frontend.pre_emphasis(torch.tensor(np.stack(want)).reshape(4, 3, 160))
        torch.testing.assert_close(shifts, pre, rtol=0, atol=0)
        taps = np.array([[f.x1, f.x2, f.y1, f.y2] for f in bps], np.float32)
        np.testing.assert_array_equal(st.bp.numpy(), taps)
    assert set(np.float32([1.0, 0.5, 0.6])) <= seen  # the levels give distinct gains
    assert (GAIN_09 in seen) == (level0 == LEVEL_09), sorted(seen)
    assert GAIN_09.view(np.uint32) == 0x3F666667 and np.float32(0.9) not in seen


@pytest.mark.parametrize("max_gain", [1.0, 1.3])
def test_gain_steps_round_as_the_jax_step(max_gain):
    """Every step k = 1 .. 10 (.. 13 at max_gain 1.3) through both packages'
    prepare_chunk and through the host classes. A chunk of constant 0.25 has
    rms 0.25 exactly, so a fresh window's mean is 0.25, and ref = k/20 gives
    ref / sqrt(mean) within an ulp of k/10: floor(·10 + 0.5) = k. Both steps
    give clip(fl32(k · fl32(0.1)), min_gain, max_gain) bit for bit; the host
    classes give k/10, which differs at k = 9 (and at 13 before the clamp)."""
    from rustpotter_tpu.runtime.stream_step import prepare_chunk as jax_prepare_chunk

    jcfg, cfg = configs("gain")
    for c in (jcfg, cfg):
        c.filters.gain_normalizer.max_gain = max_gain
    ww, jww, _ = ww_pair()
    jstatic, jparams = jax_build_bundle([("w", jww)], jcfg)
    static, params = build_bundle([("w", ww)], cfg, "cpu")
    jprep = jax.jit(lambda p, s, x: jax_prepare_chunk(jstatic, p, s, x))
    x = np.full(480, 0.25, np.float32)
    lo, hi = np.float32(static.gain_min), np.float32(static.gain_max)
    ks = np.arange(1, int(round(max_gain * 10)) + 1)
    refs = (ks / 20).astype(np.float32)
    mine, theirs, host = [], [], []
    for ref in refs:
        jst, _ = jprep(dataclasses.replace(jparams, gain_ref_sqrt=jnp.float32(ref)),
                       jax_init_state(jstatic), jnp.asarray(x))
        st, _ = prepare_chunk(static, dataclasses.replace(params, gain_ref_sqrt=torch.tensor(ref)),
                              init_state(static, 1, "cpu"), torch.tensor(x[None]))
        theirs.append(np.float32(jst.gain))
        mine.append(st.gain.numpy()[0])
        oracle = filters.GainNormalizerFilter(static.gain_min, static.gain_max)
        oracle.set_rms_level_ref(float(ref) ** 2, static.gain_window_size)
        oracle.rms_level_sqrt = ref  # the step's ref exactly
        host.append(oracle.filter(x, np.float32(0.25))[1])
    mine, theirs, host = (np.array(v, np.float32) for v in (mine, theirs, host))
    want = np.clip(ks.astype(np.float32) * np.float32(GAIN_STEP), lo, hi).astype(np.float32)
    np.testing.assert_array_equal(theirs.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(mine.view(np.uint32), want.view(np.uint32))
    divided = np.clip(ks.astype(np.float32) / np.float32(10), lo, hi).astype(np.float32)
    np.testing.assert_array_equal(host, divided)
    assert list(ks[host != want]) == [9]  # 13's product rounds up past max_gain 1.3


def test_biquad_wrapper_checks_shapes_and_devices():
    coeffs = filters.band_pass_coefficients(16000.0, 80.0, 400.0)
    with pytest.raises(ValueError, match=r"signal must be \(B, n\)"):
        biquad.biquad(coeffs, torch.zeros(2, 4), torch.zeros(480))
    with pytest.raises(ValueError, match=r"state must be \(2, 4\)"):
        biquad.biquad(coeffs, torch.zeros(3, 4), torch.zeros(2, 480))
    with pytest.raises(ValueError, match="unsupported device"):
        biquad.biquad(coeffs, torch.zeros(2, 4, device="meta"), torch.zeros(2, 480, device="meta"))


def test_front_writes_its_state_into_the_given_tensors():
    """`front(..., win_out=, count_out=, gain_out=, taps_out=)` writes the
    window, count, gain and taps into the tensors given (the stream steps
    pass their state's own), with the values
    of the plain version; the tensors of a filter that is off stay as they
    were; the samples always come out in a new tensor."""
    rng = np.random.default_rng(6)
    coeffs = filters.band_pass_coefficients(16000.0, 80.0, 400.0)
    x = torch.tensor(rng.normal(0, 0.3, (5, 480)).astype(np.float32))
    win = torch.tensor(rng.uniform(0.01, 0.1, (5, 7)).astype(np.float32))
    count = torch.tensor([0, 3, 7, 7, 1], dtype=torch.int32)
    taps = torch.tensor(rng.normal(0, 0.1, (5, 4)).astype(np.float32))
    gain = biquad.GainIn(frontend.rms_level(x), torch.tensor(np.float32(0.2)), 0.1, 1.0, win, count)
    want = biquad.front_plain(x, gain, coeffs, taps)
    for form in FILTERS:
        g_on, bp_on = FILTERS[form]
        st = [win.clone(), count.clone(), torch.zeros(5), taps.clone()]
        got = biquad.front(x, gain._replace(win=st[0], count=st[1]) if g_on else None,
                           coeffs if bp_on else None, st[3] if bp_on else None,
                           win_out=st[0], count_out=st[1], gain_out=st[2], taps_out=st[3])
        if g_on:
            assert got.win is st[0] and got.count is st[1] and got.gain is st[2]
            for name in ("win", "count", "gain"):
                torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)
        else:
            assert got.win is got.count is got.gain is None
            assert torch.equal(st[0], win) and torch.equal(st[1], count) and not st[2].any()
        if bp_on:
            assert got.taps is st[3]
        else:
            assert got.taps is None and torch.equal(st[3], taps)
        assert got.out is not x
        if form == "both":
            torch.testing.assert_close(got.out, want.out, rtol=0, atol=0)
            torch.testing.assert_close(got.taps, want.taps, rtol=0, atol=0)
    assert biquad.front(x).out is x  # both filters off: nothing runs
    with pytest.raises(ValueError, match="win_out must be"):
        biquad.front(x, gain, win_out=torch.zeros(5, 6))
    with pytest.raises(ValueError, match="taps_out must be"):
        biquad.front(x, None, coeffs, taps, taps_out=torch.zeros(5, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"gain: rms \(5,\)"):
        biquad.front(x, gain._replace(count=count[:4]))


# ------------------------------------------------------------ end to end

def assert_seen_gain_09(seen, what, level1):
    """With the gain on and stream 1 at LEVEL_09, the steps' 0.9 was reached."""
    assert (GAIN_09 in seen) == (FILTERS[what][0] and level1 == LEVEL_09), sorted(seen)


@pytest.mark.parametrize("what, level1", CASES)
def test_batched_detector_with_filters_matches_jax(workload, what, level1):
    ww, jww, frames = frames_at(workload, level1)
    seen = set()
    ev = compare_batched(jww, ww, frames, *configs(what), seen=seen)
    assert ev["fired"][:, 0].sum() == 1
    # the gain normalizer scaled the utterance down, and only where it is on
    assert (ev["gain"][ev["fired"]] < 1.0).all() == FILTERS[what][0]
    assert_seen_gain_09(seen, what, level1)


@pytest.mark.parametrize("what, level1", CASES)
def test_make_step_with_filters_matches_jax(workload, what, level1):
    ww, jww, frames = frames_at(workload, level1)
    seen = set()
    assert compare_step(jww, ww, frames, *configs(what), seen=seen) == 1
    assert_seen_gain_09(seen, what, level1)


@pytest.mark.parametrize("what, level1", CASES)
def test_rustpotter_with_filters_matches_jax(workload, what, level1):
    """The single stream is the utterance; at LEVEL_09 it follows LEAD
    chunks of stream 1 (gain 0.9), which leave the gain window before the
    utterance."""
    ww, jww, frames = frames_at(workload, level1)
    single = frames[:, 0]
    if level1 == LEVEL_09:
        single = np.concatenate([frames[:LEAD, 1], single])
    seen = set()
    assert len(compare_rustpotter(jww, ww, single, *configs(what), seen=seen)) == 1
    assert_seen_gain_09(seen, what, level1)


def test_band_pass_ring_down_after_digital_silence(workload):
    """After the utterance, exact digital silence makes the band-pass ring
    down through FLT_MIN within two chunks. The JAX package's CPU runtime
    flushes subnormals to zero, so its taps reach exactly 0; the port keeps
    IEEE gradual underflow, as the host oracle does (its taps are the
    oracle's bit for bit: a limit cycle of a few subnormal ulps) and as the
    kernel does on the card. The log-mel of the frames that cross FLT_MIN
    then differs by up to ~1 in an MFCC. Held: the events (scores at
    EV_TOL), every state as in the other tests, and every window row
    outside WIN_TOL was written in the chunk where stream 0's filtered audio
    first reaches the subnormal range, or the next."""
    ww, jww, stream0 = workload
    frames = level_streams(stream0, 5, floor=0.0)
    jcfg, cfg = configs("band_pass")
    jdet = JaxBatchedDetector([("w", jww)], jcfg, batch_size=B)
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device="cpu")
    oracle = filters.BandPassFilter(16000, 80.0, 400.0)
    F = det.static.max_mfcc_frames
    written = np.full(F, -1)  # the chunk that wrote each window row
    ring_down, fired = None, 0
    jst, st = jdet.init_states(), det.init_states()
    for t in range(frames.shape[0]):
        jst, jev = jdet.process_chunk(jdet.params, jst, jnp.asarray(frames[t]))
        st, ev = det.process_chunk(det.params, st, frames[t])
        rot = int(st.rot)
        written[[(rot - 2) % F, (rot - 1) % F, rot]] = t
        y = oracle.filter(frames[t, 0])
        if ring_down is None and ((y != 0) & (np.abs(y) < np.finfo(np.float32).tiny)).any():
            ring_down = t
        got, want = states_to_numpy(st), _numpy(jst)
        assert_event_equal(events_to_numpy(ev)._asdict(), _numpy(jev), t)
        fired += int(ev.fired[0])
        np.testing.assert_array_equal(got["bp"][0], [oracle.x1, oracle.x2, oracle.y1, oracle.y2])
        bad = ~np.isclose(got["win"], want["win"], **WIN_TOL)
        rows = np.nonzero(bad.any(axis=(1, 2)))[0]
        assert not bad[..., 1:].any(), t  # only stream 0 rings down
        allowed = set() if ring_down is None else {ring_down, ring_down + 1}
        assert set(written[rows]) <= allowed, (t, rows)
        got["win"] = want["win"]
        assert_state_equal(got, want, t)
    assert fired == 1 and ring_down is not None
    assert (np.asarray(jst.bp)[0] == 0).all() and (st.bp[0] != 0).any()
    assert np.abs(st.bp[0].numpy()).max() < np.finfo(np.float32).tiny
