"""Wakeword management on a live `BatchedDetector` of the PyTorch port
(device="cpu") against the JAX package's on the CPU: the cases of
tests/test_batch_management.py, each run on both detectors in lockstep
(the same audio, the same add / remove / update calls on live states), plus
an NN wakeword added to and removed from a live DTW fleet, and the filters
enabled on a live fleet.

After every chunk the events must be equal (fired, ww, counter; scores
rtol 2e-5 / atol 2e-5 for DTW, rtol 1e-4 / atol 1e-3 once an NN wakeword
is in the bundle); after every call the migrated states must be equal
(counters, flags, cursor, window length exactly; window rows at rtol 1e-5 /
atol 1e-4; partial scores at the score tolerance; with the band-pass on, its
taps at atol 1e-5, since the JAX package's scan contracts products into FMAs,
tests/test_torch_filters.py).

The wakewords are the JAX test's: a chirp built through the JAX package's
MFCC pipeline (its features shared by both detectors) and seeded noise
templates that never fire.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import DetectorConfig as JaxDetectorConfig
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.mfcc.averager import average_templates
from rustpotter_tpu.mfcc.offline import mfcc_pipeline
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import DetectorConfig, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.convert import states_to_numpy
from rustpotter_tpu_torch.wakewords import nn
from rustpotter_tpu_torch.wakewords.files import ModelType, WakewordModel, WakewordRef
from test_torch_nn import jax_model

torch.set_num_threads(2)

DTW_TOL = dict(rtol=2e-5, atol=2e-5)
NN_TOL = dict(rtol=1e-4, atol=1e-3)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww", "partial_counter",
               "countdown", "vad_countdown", "rot", "gain_count", "bp", "gain")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level", "gain_win")


def _word(seed, n=5600):
    """0.35 s chirp + noise (tests/test_batch_management.py's utterance)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f = 300 + 900 * (t / t[-1])
    sig = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / 16000.0) + 0.02 * rng.normal(size=n)
    return sig.astype(np.float32)


def _pair_ref(name, feats, avg):
    """(the port's WakewordRef, the JAX package's) on the same features."""
    return (WakewordRef(name, samples_features=dict(feats), avg_features=avg, rms_level=0.05),
            JaxWakewordRef(name, samples_features=dict(feats), avg_features=avg,
                           rms_level=0.05))


@pytest.fixture(scope="module")
def chirp():
    feats = {}
    for i, seed in enumerate((1, 2, 3)):
        w = _word(seed)
        feats[f"w{i}.wav"] = np.asarray(mfcc_pipeline(w[: len(w) // 160 * 160], 6))
    items = sorted(feats.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    return _pair_ref("chirp", feats, average_templates([m for _, m in items]))


def noise_wakeword(name="short", length=30, mfcc_size=5, seed=11):
    rng = np.random.default_rng(seed)
    feats = {f"s{i}.wav": rng.normal(0, 2, (length - i, mfcc_size)).astype(np.float32)
             for i in range(3)}
    return _pair_ref(name, feats, rng.normal(0, 2, (length, mfcc_size)).astype(np.float32))


def nn_wakeword(train_size=40, seed=12):
    """A SMALL classifier on the chirp's 5 coefficients (port, JAX)."""
    params = nn.init_params(ModelType.SMALL, train_size * 5, 5, 2, seed=seed)
    m = WakewordModel(labels=["n", "none"], train_size=train_size, mfcc_size=5,
                      m_type=ModelType.SMALL, weights=nn.params_to_tensor_data(params),
                      rms_level=0.05)
    return m, jax_model(m)


@pytest.fixture(scope="module")
def frames():
    """(T, 480) stream: 0.5 s silence + chirp word + 1 s silence."""
    s = np.concatenate([np.zeros(8000, np.float32), _word(1), np.zeros(16000, np.float32)])
    n = len(s) // 480
    return s[: n * 480].reshape(n, 480)


def configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    for c in (jcfg, cfg):
        c.detector.avg_threshold = 0.2
        c.detector.threshold = 0.5
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    return jcfg, cfg


def staggered_batch(frames, offsets, b):
    """(T, B, 480): stream i plays `frames` delayed by offsets[i % len] frames."""
    T = frames.shape[0]
    out = np.zeros((T, len(offsets), 480), np.float32)
    for j, off in enumerate(offsets):
        out[off:, j] = frames[: T - off]
    reps = -(-b // len(offsets))
    return np.tile(out, (1, reps, 1))[:, :b]


def same_audio(frames, b):
    """(T, B, 480): every stream plays `frames`."""
    return np.ascontiguousarray(np.broadcast_to(frames[:, None], frames.shape[:1] + (b, 480)))


def _numpy(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


class Lockstep:
    """A JAX BatchedDetector and the port's, driven by the same calls; every
    result is held to the JAX one before it is returned."""

    def __init__(self, wakewords, batch_size, cfgs=None):
        jcfg, cfg = cfgs or configs()
        self.jdet = JaxBatchedDetector([(k, j) for k, (_, j) in wakewords], jcfg,
                                       batch_size=batch_size)
        self.det = BatchedDetector([(k, p) for k, (p, _) in wakewords], cfg,
                                   batch_size=batch_size, device="cpu")
        self.jst, self.st = self.jdet.init_states(), self.det.init_states()
        self.check_states()

    @property
    def tol(self):
        return NN_TOL if self.det.static.nn_meta else DTW_TOL

    def check_states(self):
        assert self.det.wakeword_names == self.jdet.wakeword_names
        got, want = states_to_numpy(self.st), _numpy(self.jst)
        exact = EXACT_STATE
        if self.det.static.bp_enabled:
            exact = tuple(f for f in EXACT_STATE if f != "bp")
            np.testing.assert_allclose(got["bp"], want["bp"], rtol=0, atol=1e-5, err_msg="bp")
        for f in exact:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        for f in CLOSE_STATE:
            np.testing.assert_allclose(got[f], want[f], **self.tol, err_msg=f)
        np.testing.assert_allclose(got["win"], want["win"], **WIN_TOL, err_msg="win")
        np.testing.assert_array_equal(np.isnan(got["vad_win"]), np.isnan(want["vad_win"]))
        return got

    def run(self, batch):
        """Both detectors over batch (T, B, 480); the port's events, stacked."""
        evs = []
        for t in range(batch.shape[0]):
            self.jst, jev = self.jdet.process_chunk(self.jdet.params, self.jst,
                                                    jnp.asarray(batch[t]))
            self.st, ev = self.det.process_chunk(self.det.params, self.st, batch[t])
            got, want = events_to_numpy(ev)._asdict(), _numpy(jev)
            for f in ("fired", "ww", "counter"):
                np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
            fired = want["fired"]
            for f in ("score", "avg_score", "scores"):
                np.testing.assert_allclose(got[f][fired], want[f][fired], **self.tol,
                                           err_msg=f"chunk {t} {f}")
            evs.append(got)
        self.check_states()
        return {f: np.stack([e[f] for e in evs]) for f in evs[0]}

    def call(self, method, *args):
        """det.method(*port args, states) beside jdet.method(*JAX args, states);
        each arg is a (port, JAX) pair."""
        self.jst = getattr(self.jdet, method)(*[j for _, j in args], self.jst)
        self.st = getattr(self.det, method)(*[p for p, _ in args], self.st)
        return self.check_states()


def _same(x):
    return (x, x)


def test_add_wakeword_mid_partial_preserves_counters(frames, chirp):
    B = 16
    batch = staggered_batch(frames, [0, 3, 6, 9], B)
    base = Lockstep([("chirp", chirp)], B).run(batch)
    assert (base["fired"].sum(axis=0) == 1).all()
    t_fire = base["fired"].argmax(axis=0)
    split = int(t_fire[0]) - 3
    ls = Lockstep([("chirp", chirp)], B)
    ev1 = ls.run(batch[:split])
    assert ls.st.partial_active[0]  # genuinely mid-partial
    ls.call("add_wakeword", _same("short"), noise_wakeword())
    assert ls.det.wakeword_names == ("chirp", "short")
    ev2 = ls.run(batch[split:])
    np.testing.assert_array_equal(np.concatenate([ev1["fired"], ev2["fired"]]), base["fired"])
    for b in range(B):
        t = t_fire[b]
        seg, tt = (ev1, t) if t < split else (ev2, t - split)
        assert seg["counter"][tt, b] == base["counter"][t, b]
        assert ls.det.wakeword_names[int(seg["ww"][tt, b])] == "chirp"


def test_remove_wakeword_mid_partial_preserves_counters(frames, chirp):
    batch = staggered_batch(frames, [0, 7], 8)
    wws = [("chirp", chirp), ("short", noise_wakeword())]
    base = Lockstep(wws, 8).run(batch)
    split = int(base["fired"].argmax(axis=0)[0]) - 3
    ls = Lockstep(wws, 8)
    ev1 = ls.run(batch[:split])
    ls.call("remove_wakeword", _same("short"))
    assert ls.det.wakeword_names == ("chirp",)
    ev2 = ls.run(batch[split:])
    np.testing.assert_array_equal(np.concatenate([ev1["fired"], ev2["fired"]]), base["fired"])


def test_remove_partial_wakeword_drops_partial(frames, chirp):
    batch = same_audio(frames, 4)
    wws = [("chirp", chirp), ("short", noise_wakeword())]
    base = Lockstep(wws, 4).run(batch)
    split = int(base["fired"].argmax(axis=0)[0]) - 3
    ls = Lockstep(wws, 4)
    ls.run(batch[:split])
    assert ls.st.partial_active.all()
    got = ls.call("remove_wakeword", _same("chirp"))
    assert not got["partial_active"].any() and (got["countdown"] == 0).all()
    assert not ls.run(batch[split:])["fired"].any()  # only the noise wakeword remains


def test_add_longer_wakeword_grows_window_and_still_detects(frames, chirp):
    batch = same_audio(frames, 2)
    ls = Lockstep([("chirp", chirp)], 2)
    F_old = ls.det.static.max_mfcc_frames
    ls.run(batch[:20])
    wc_before = int(ls.st.win_count[0])
    got = ls.call("add_wakeword", _same("long"), noise_wakeword("long", length=60, seed=13))
    assert ls.det.static.max_mfcc_frames == 60 > F_old
    assert got["win"].shape == (60, 5, 2)  # stream-minor (F, C, B)
    assert int(got["win_count"][0]) == wc_before  # carried, refills
    ev = ls.run(batch[20:])
    assert ev["fired"].sum(axis=0).tolist() == [1, 1]  # chirp still detected
    t = ev["fired"].argmax(axis=0)[0]
    assert ls.det.wakeword_names[int(ev["ww"][t, 0])] == "chirp"


def test_add_wakeword_mfcc_mismatch_rolls_back(chirp):
    det = BatchedDetector([("chirp", chirp[0])], configs()[1], batch_size=2, device="cpu")
    static, params = det.static, det.params
    with pytest.raises(ValueError, match="mfcc size"):
        det.add_wakeword("bad", noise_wakeword(mfcc_size=16)[0])
    assert det.wakeword_names == ("chirp",)
    assert det.static is static and det.params is params  # nothing adopted
    det.process_chunk(det.params, det.init_states(), np.zeros((2, 480), np.float32))


def test_remove_last_wakeword_rejected(chirp):
    det = BatchedDetector([("chirp", chirp[0])], configs()[1], batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="last wakeword"):
        det.remove_wakeword("chirp")
    with pytest.raises(KeyError):
        det.remove_wakeword("nope")


def test_update_detector_config_resets_stream_keeps_filters(frames, chirp):
    """The JAX test's calls with the filters off: the detector config resets
    stream state and keeps the filter and encoder fields; the filters update
    resets them (test_update_filters_config_on_a_live_fleet turns them on)."""
    batch = same_audio(frames, 2)
    ls = Lockstep([("chirp", chirp)], 2)
    ls.run(batch[:20])
    new = []
    for cls, mode in ((JaxDetectorConfig, JaxScoreMode), (DetectorConfig, ScoreMode)):
        c = cls()
        c.score_mode, c.threshold = mode.MEDIAN, 0.4
        new.append(c)
    got = ls.call("update_detector_config", (new[1], new[0]))
    assert ls.det.static.score_mode == ScoreMode.MEDIAN
    assert int(got["win_count"][0]) == 0 and int(got["ext_count"][0]) == 0
    assert not got["partial_active"].any()
    assert (got["rms_level"] > 0).all()  # the encoder's level carries over
    ls.run(batch[20:30])
    got = ls.call("update_filters_config", (ls.det.config.filters, ls.jdet.config.filters))
    np.testing.assert_array_equal(got["bp"], 0.0)
    assert int(got["gain_count"][0]) == 0
    ls.run(batch[30:])


def test_update_filters_config_on_a_live_fleet(frames, chirp):
    """Both filters turned on mid-stream through update_filters_config, then
    the gain normalizer off through update_config: each call rebuilds the
    filters with fresh taps and gain window and resets the stream, as the
    JAX package migrates; the events after each call equal its events. The
    audio has a microphone's noise floor (tests/test_torch_filters.py takes
    exact silence after a band-pass). The band-pass is set around the
    chirp's 300-1200 Hz, whose templates are unfiltered, so that it fires."""
    noisy = frames + np.random.default_rng(7).normal(0, 1e-3, frames.shape).astype(np.float32)
    batch = staggered_batch(noisy, [0, 4], 4)
    ls = Lockstep([("chirp", chirp)], 4)
    ls.run(batch[:6])
    filters = [RustpotterConfig().filters, JaxConfig().filters]
    for f in filters:
        f.gain_normalizer.enabled = f.band_pass.enabled = True
        f.band_pass.low_cutoff, f.band_pass.high_cutoff = 200.0, 1300.0
    got = ls.call("update_filters_config", tuple(filters))
    assert ls.det.static.gain_enabled and ls.det.static.bp_enabled
    np.testing.assert_array_equal(got["bp"], 0.0)
    assert (got["gain_count"] == 0).all() and (got["gain"] == 1.0).all()
    assert not got["partial_active"].any() and (got["win_count"] == 0).all()
    ev = ls.run(batch[6:45])
    cfgs = [RustpotterConfig(), JaxConfig()]
    for c, f in zip(cfgs, filters):
        c.detector.avg_threshold, c.detector.threshold = 0.2, 0.5
        c.filters = f
        f.gain_normalizer.enabled = False
    cfgs[0].detector.score_mode, cfgs[1].detector.score_mode = ScoreMode.MAX, JaxScoreMode.MAX
    got = ls.call("update_config", tuple(cfgs))
    assert not ls.det.static.gain_enabled and ls.det.static.bp_enabled
    np.testing.assert_array_equal(got["bp"], 0.0)
    ls.run(batch[45:])
    assert (ev["fired"].sum(axis=0) == 1).all()
    assert (ev["gain"][ev["fired"]] < 1.0).all()  # the gain normalizer scaled the word


def test_add_and_remove_nn_wakeword_on_live_fleet(frames, chirp):
    """An NN wakeword (train_size 40 > the chirp's 32 frames) joins a live
    DTW fleet mid-stream: the window grows, partial scores widen to the
    labels, the chirp still fires; then it leaves again."""
    batch = staggered_batch(frames, [0, 4], 4)
    ls = Lockstep([("chirp", chirp)], 4)
    ls.run(batch[:15])
    got = ls.call("add_wakeword", _same("nn"), nn_wakeword())
    assert ls.det.wakeword_names == ("chirp", "nn")
    assert got["win"].shape == (40, 5, 4) and ls.det.static.smax == 3
    ev = ls.run(batch[15:])
    assert ev["fired"][:, :2].sum(axis=0).tolist() == [1, 1]
    got = ls.call("remove_wakeword", _same("nn"))
    assert got["win"].shape == (32, 5, 4)
    ls.run(batch[:30])
