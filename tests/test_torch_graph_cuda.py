"""The port's serving paths as CUDA graphs on a card (`runtime/graph.py`):
each graphed entry point against the eager function on the same audio,
over the correctness stream of the bench wakeword (stream 0 the utterance,
the rest seeded noise): `BatchedDetector` (the DTW chunk, `nn_medium`,
`mixed`, the benchmark's `mixed` deployment at B = 8192 (three DTW
wakewords of 8 templates and a LARGE NN wakeword, 168 frames), the filters,
48 kHz in-graph resampling; `process_sequence`; a live
`add_wakeword`, `reset_streams`, `update_filters_config`; two state sets in
turns), `make_step` in its K2, K4 and K3 modes, and `Rustpotter`
(`process_audio`, `process_audio_sequence`, held to `make_step`'s events);
each kernel's launch count per replay, and the kernels a replay runs as
torch.profiler sees them; a detector on a card other than the current one
(two cards); the kernels past 48 KB of shared memory (K2 at w = 9, K3, K1
at w = 10) on cuda:0, then on cuda:1 in the same process, against the CPU
(F3, two cards); a capture that reads the host raises. Every test needs a card
(and nvcc, which builds the kernels at first use); without one they skip.
The file imports no JAX:

    python -m pytest tests/test_torch_graph_cuda.py -m cuda --noconftest -q -s

Tolerances: events equal (fired, ww, counter); scores, gains and states at
the CPU tests' rtol 2e-5 / atol 2e-5 (NN scores rtol 1e-4 / atol 1e-3, the
window's MFCC rows rtol 1e-5 / atol 1e-4). The graph runs the eager path's
kernels, so bit-equality is expected; under capture cuBLAS may choose other
algorithms, so it is printed (-s), not asserted.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import AudioFmt, Rustpotter, RustpotterConfig, SampleFormat, ScoreMode
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import biquad, frontend
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime import graph
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.state import Event, init_state
from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk, make_step
from rustpotter_tpu_torch.synthetic import (
    bench_utterances,
    build_bench_wakeword,
    build_firing_nn_wakeword,
    correctness_stream,
)
from rustpotter_tpu_torch.utils.profiling import profiled_launches

B = 64
EV_TOL = dict(rtol=2e-5, atol=2e-5)
NN_TOL = dict(rtol=1e-4, atol=1e-3)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU build")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def words():
    """(the bench wakeword, an NN wakeword that fires on its utterance, the
    utterance); built on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ww, utterance = build_bench_wakeword(device="cuda")
    return ww, build_firing_nn_wakeword(utterance, device="cuda"), utterance


def config(filters=False, rate=16000):
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = filters
    if rate != 16000:
        cfg.fmt = AudioFmt(sample_rate=rate, sample_format=SampleFormat.F32)
    return cfg


def stream_frames(utterance, F, n=480, seed=0, device="cuda", b=B):
    """(T, b, n) chunks on `device`: stream 0 the correctness stream, the
    rest noise."""
    s0 = correctness_stream(F, utterance, n)
    frames = np.random.default_rng(seed).normal(0, 0.05, (len(s0), b, n)).astype(np.float32)
    frames[:, 0] = s0
    return torch.tensor(frames, device=device)


def counts():
    return {**fd.LAUNCHES, **bd.LAUNCHES, **biquad.LAUNCHES, **frontend.LAUNCHES}


def run(process, states, frames):
    """process(states, x) over frames (T, ...): (the final states, the
    Events stacked (T, B, ...), the launches counted)."""
    before = counts()
    evs = []
    for t in range(frames.shape[0]):
        states, ev = process(states, frames[t])
        evs.append(ev)
    torch.cuda.synchronize(frames.device)
    launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    return states, Event(*[torch.stack(f) for f in zip(*evs)]), launched


def bits(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def held(got, want, what, tol=EV_TOL, got_states=None, want_states=None) -> bool:
    """Raises unless the graphed run's events (and states) equal the eager
    run's at the tolerances; returns whether every bit is equal."""
    for f in ("fired", "ww", "counter"):
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)
    fired = want.fired
    same = True
    for f in ("score", "avg_score", "gain", "scores"):
        torch.testing.assert_close(getattr(got, f)[fired], getattr(want, f)[fired], **tol,
                                   equal_nan=True, msg=f"{what}: {f}")
        same &= bits(getattr(got, f), getattr(want, f))
    for f, a, b in zip(got_states._fields if got_states else (), got_states or (),
                       want_states or ()):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, **(WIN_TOL if f == "win" else tol),
                                       equal_nan=True, msg=f"{what}: state {f}")
        else:
            assert torch.equal(a, b), (what, f)
        same &= bits(a, b)
    print(f"{what}: graphed equals eager; bit-equal {same}")
    return same


def replays_run(graphed, eager, launches, n, what, device="cuda"):
    """Raises unless torch.profiler sees a replay of `graphed` run each of
    the port's kernels as often as an eager call does, and the kernels the
    counts (`launches` over n calls) name: the graph holds them. (K1 and K2
    launch twice per wrapper call, the ungated templates and the gated.)"""
    with torch.cuda.device(device):
        got, total_g = profiled_launches(graphed, 3)
        want, total_e = profiled_launches(eager, 3)
    assert got == want and set(got) == set(launches), (what, got, want, launches)
    assert all(got[k] >= launches[k] / n > 0 for k in got), (what, got, launches)
    print(f"{what}: a replay runs {total_g} device kernels, an eager call {total_e}")


def mixed_fleet_case():
    """The benchmark's `mixed` deployment (portbench/configs/mixed.json) at
    B = 8192, its wakewords made by the benchmark from a seed, and the
    frames of its first utterance."""
    from portbench import harness, synth
    from portbench import wakewords as bench_ww

    conf = harness.load_json(harness.ROOT, "portbench", "configs", "mixed.json")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    objs, cfg = bench_ww.for_program(bench_ww.build(conf, gen, torch.device("cuda")), conf)
    det = BatchedDetector(objs, cfg, batch_size=8192, device="cuda")
    utt = synth.utterances(conf["wakewords"][0]["utterances"])[0]
    return det, stream_frames(utt, det.static.max_mfcc_frames, b=8192), NN_TOL


def batched_case(words, case):
    if case == "mixed_fleet":
        return mixed_fleet_case()
    ww, firing, utterance = words
    dtw = [("w", ww)]
    cases = {
        "dtw": (dtw, config(), 480, False, EV_TOL),
        "nn_medium": ([("n", firing)], config(), 480, False, NN_TOL),
        "mixed": (dtw + [("n", firing)], config(), 480, False, NN_TOL),
        "filtered": (dtw, config(filters=True), 480, False, EV_TOL),
        "48k": (dtw, config(rate=48000), 1440, True, EV_TOL),
    }
    wakewords, cfg, n, resample, tol = cases[case]
    det = BatchedDetector(wakewords, cfg, batch_size=B, device="cuda",
                          in_graph_resample=resample)
    u = utterance if n == 480 else bench_utterances(100, 48000)[0]
    return det, stream_frames(u, det.static.max_mfcc_frames, n), tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtw", "nn_medium", "mixed", "mixed_fleet", "filtered", "48k"])
def test_batched_chunk_graph_equals_eager(cuda_device, words, case):
    det, frames, tol = batched_case(words, case)
    eager = make_batched_chunk(det.static)
    sg, evg, lg = run(lambda s, x: det.process_chunk(det.params, s, x), det.init_states(), frames)
    se, eve, le = run(lambda s, x: eager(det.params, s, x), det.init_states(), frames)
    assert det._chunk.captures == 1
    assert lg == le, (lg, le)  # launches counted per replay, as the eager run's
    k1 = frames.shape[0] if det.static.n_dtw else 0
    assert lg.get("fused_dtw_v4", 0) == k1
    assert lg.get("biquad", 0) == (frames.shape[0] if case == "filtered" else 0)
    assert bool(evg.fired[:, 0].any()), case
    held(evg, eve, case, tol, sg, se)
    # process_sequence: T replays of a graph of its own state set
    ss, evs = det.process_sequence(det.params, det.init_states(), frames)
    held(evs, evg, f"{case} process_sequence", tol, ss, sg)
    replays_run(lambda: det.process_chunk(det.params, sg, frames[-1]),
                lambda: eager(det.params, se, frames[-1]), lg, frames.shape[0], case)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["K2", "K4", "K3"])
def test_make_step_graph_equals_eager(cuda_device, words, mode):
    ww, _, utterance = words
    static, params = build_bundle([("w", ww)], config(), "cuda",
                                  dtw_fused=False if mode == "K3" else None)
    if mode == "K4":
        static = dataclasses.replace(static, dtw_fused_variant=2)
    kernel = {"K2": "fused_dtw_v3", "K4": "fused_dtw_v2", "K3": "banded_dtw"}[mode]
    frames = stream_frames(utterance, static.max_mfcc_frames)
    step = graph.GraphedStep(make_step(static))
    eager = make_step(static)
    sg, evg, lg = run(lambda s, x: step(params, s, x), init_state(static, B, "cuda"), frames)
    se, eve, le = run(lambda s, x: eager(params, s, x), init_state(static, B, "cuda"), frames)
    assert lg == le == {kernel: 3 * frames.shape[0], "mfcc_epilogue": 3 * frames.shape[0]}, (
        lg, le)
    assert step.captures == 1 and bool(evg.fired[:, 0].any())
    held(evg, eve, f"make_step {mode}", EV_TOL, sg, se)
    replays_run(lambda: step(params, sg, frames[-1]), lambda: eager(params, se, frames[-1]),
                lg, frames.shape[0], f"make_step {mode}")


def _detections(rp, frames):
    out = []
    for i, frame in enumerate(frames):
        d = rp.process_audio(frame)
        if d is not None:
            out.append((i, d))
    return out


def rustpotter_held(rp, wakewords, cfg, frames, device):
    """Raises unless the graphed Rustpotter `rp` over `frames` detects at
    the frames where `make_step` at B = 1 fires, with its counter, gain
    and scores, and launches K2 3 times per frame; then that
    `process_audio_sequence` after a reset gives the same detections without
    capturing again. Returns the detections."""
    static, params = build_bundle(wakewords, cfg, device)
    step, state, evs = make_step(static), init_state(static, 1, device), []
    before = fd.LAUNCHES["fused_dtw_v3"]
    got = _detections(rp, frames)
    assert fd.LAUNCHES["fused_dtw_v3"] - before == 3 * len(frames)
    for frame in frames:
        state, ev = step(params, state, torch.as_tensor(frame, device=device).reshape(1, -1))
        evs.append(ev)
    want = Event(*[torch.cat(f).cpu() for f in zip(*evs)])
    assert got and [i for i, _ in got] == torch.nonzero(want.fired)[:, 0].tolist()
    for i, d in got:
        assert d.counter == int(want.counter[i]) and d.name == rp.wakewords[0][1].name
        np.testing.assert_equal(np.float32(d.gain), want.gain[i].numpy())  # NaN = NaN
        np.testing.assert_allclose(
            [d.score, d.avg_score, *d.scores.values()],
            [float(want.score[i]), float(want.avg_score[i]),
             *want.scores[i, :len(d.scores)].tolist()], **EV_TOL)
    captures = rp._step.captures
    rp.reset()  # in place: the graph stays
    seq = rp.process_audio_sequence(frames.reshape(-1))
    assert rp._step.captures == captures == 1
    assert [(d.name, d.counter, d.score) for d in seq] == [
        (d.name, d.counter, d.score) for _, d in got]
    return got


@pytest.mark.cuda
def test_rustpotter_graph_equals_eager(cuda_device, words):
    ww, _, utterance = words
    rp = Rustpotter(config(), device="cuda")
    rp.add_wakeword_ref("w", ww)
    rustpotter_held(rp, [("w", ww)], config(), correctness_stream(100, utterance), "cuda")


@pytest.mark.cuda
def test_a_detector_on_another_card_than_the_current_one(cuda_device, words):
    """BatchedDetector and Rustpotter on cuda:1 while cuda:0 is current:
    the capture and the replays run on cuda:1, so the graph holds the
    chunk's kernels and its events are the eager chunk's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ww, _, utterance = words
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    det = BatchedDetector([("w", ww)], config(), batch_size=B, device=dev)
    frames = stream_frames(utterance, det.static.max_mfcc_frames, device=dev)
    eager = make_batched_chunk(det.static)
    sg, evg, lg = run(lambda s, x: det.process_chunk(det.params, s, x), det.init_states(), frames)
    se, eve, le = run(lambda s, x: eager(det.params, s, x), det.init_states(), frames)
    assert torch.cuda.current_device() == 0 and det._chunk.captures == 1
    T = frames.shape[0]
    assert lg == le == {"fused_dtw_v4": T, "mfcc_prologue": T, "mfcc_epilogue": T}
    assert bool(evg.fired[:, 0].any())
    held(evg, eve, "cuda:1 batched", EV_TOL, sg, se)
    ss, evs = det.process_sequence(det.params, det.init_states(), frames)
    held(evs, evg, "cuda:1 process_sequence", EV_TOL, ss, sg)
    replays_run(lambda: det.process_chunk(det.params, sg, frames[-1]),
                lambda: eager(det.params, se, frames[-1]), lg, frames.shape[0], "cuda:1", dev)
    rp = Rustpotter(config(), device=dev)
    rp.add_wakeword_ref("w", ww)
    rustpotter_held(rp, [("w", ww)], config(), correctness_stream(100, utterance), dev)
    assert torch.cuda.current_device() == 0


# F3: paths whose kernel asks for more than 48 KB of shared memory at C = 16
# (kind, band, bundle options): K2 from w = 9, K3 at every band, K1 from w = 10
F3_PATHS = (("make_step K2", 9, {}), ("make_step K3", 5, {"dtw_fused": False}),
            ("BatchedDetector K1", 10, {}))
B_F3 = 8


def _f3_events(ww, utterance, device):
    """{path: the Events (T, B_F3, ...) on the CPU} of each F3 path on
    `device` over the correctness stream: make_step graphed on the card
    (eager on the CPU), BatchedDetector.process_chunk."""
    out = {}
    for what, band, opts in F3_PATHS:
        cfg = config()
        cfg.detector.band_size = band
        if what.startswith("BatchedDetector"):
            det = BatchedDetector([("w", ww)], cfg, batch_size=B_F3, device=device)
            static, states = det.static, det.init_states()
            process = lambda s, x, det=det: det.process_chunk(det.params, s, x)
        else:
            static, params = build_bundle([("w", ww)], cfg, device, **opts)
            step = graph.GraphedStep(make_step(static))
            states = init_state(static, B_F3, device)
            process = lambda s, x, step=step, params=params: step(params, s, x)
        assert static.band_size == band
        frames = stream_frames(utterance, static.max_mfcc_frames, device=device, b=B_F3)
        evs = []
        for x in frames:
            states, ev = process(states, x)
            evs.append([f.cpu() for f in ev])
        out[what] = Event(*[torch.stack(f) for f in zip(*evs)])
    return out


@pytest.mark.cuda
def test_kernels_past_48_kb_launch_on_a_second_card(cuda_device, words):
    """F3: each launcher sets its shared-memory opt-in on every card it
    launches on, not once per process. K2 at w = 9, K3 and K1 at w = 10 run
    on cuda:0, then in the same process on cuda:1 (card 0 current), and each
    gives the CPU's events."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ww, _, utterance = words
    assert fd.k2_smem_bytes(9, 16) > 48 * 1024 and bd.smem_bytes(5) > 48 * 1024
    assert fd.k1_smem_bytes(10, 16) > 48 * 1024
    want = _f3_events(ww, utterance, "cpu")
    cards = [_f3_events(ww, utterance, torch.device("cuda", i)) for i in (0, 1)]
    assert torch.cuda.current_device() == 0
    for what, _, _ in F3_PATHS:
        for i, got in enumerate(cards):
            held(got[what], want[what], f"F3 {what} on cuda:{i} against the cpu")
        print(f"F3 {what}: cuda:1 bit-equal to cuda:0 "
              f"{all(bits(a, b) for a, b in zip(cards[1][what], cards[0][what]))}")


def _management(det, words, eager_of, device="cuda"):
    """The correctness stream through `det` with management calls on the
    way: the filters turned on at chunk 5, an NN wakeword added at 10,
    streams 1 and 2 reset at 30 (all before the utterance, so that the
    window refills and stream 0 fires). With eager_of None, det's graphed
    chunk; else eager_of(static) per rebuild. Returns the final states and
    the events."""
    _, firing, utterance = words
    frames = stream_frames(utterance, firing.train_size, device=device)
    states, evs = det.init_states(), []
    chunk = None if eager_of is None else eager_of(det.static)
    for t in range(frames.shape[0]):
        if t == 5:
            filters = copy.deepcopy(det.config.filters)
            filters.gain_normalizer.enabled = filters.band_pass.enabled = True
            states = det.update_filters_config(filters, states)
        if t == 10:
            states = det.add_wakeword("n", firing, states)
        if t in (5, 10):
            chunk = None if eager_of is None else eager_of(det.static)
        if t == 30:
            mask = torch.zeros(det.local_batch, dtype=torch.bool, device=device)
            mask[1:3] = True
            before = det._chunk.captures
            det.reset_streams(states, mask)
        if eager_of is None:
            states, ev = det.process_chunk(det.params, states, frames[t])
        else:
            states, ev = chunk(det.params, states, frames[t])
        if t == 30:
            assert det._chunk.captures == before  # an in-place reset: no capture
        evs.append(ev)
    return states, Event(*[torch.stack(f) for f in zip(*evs)])


@pytest.mark.cuda
def test_graph_after_add_wakeword_reset_and_filters_change(cuda_device, words):
    ww = words[0]
    runs = []
    for eager_of in (None, make_batched_chunk):
        det = BatchedDetector([("w", ww)], config(), batch_size=B, device="cuda")
        runs.append(_management(det, words, eager_of))
        if eager_of is None:
            # the rebuilds captured again: the last one once, at its first chunk
            assert det._chunk.captures == 1 and det.static.gain_enabled
    (sg, evg), (se, eve) = runs
    assert bool(evg.fired[:, 0].any())
    held(evg, eve, "management", NN_TOL, sg, se)


@pytest.mark.cuda
def test_two_state_sets_in_turns(cuda_device, words):
    ww, _, utterance = words
    det = BatchedDetector([("w", ww)], config(), batch_size=B, device="cuda")
    eager = make_batched_chunk(det.static)
    frames = stream_frames(utterance, det.static.max_mfcc_frames)
    other = stream_frames(utterance, det.static.max_mfcc_frames, seed=1)
    g = [det.init_states(), det.init_states()]
    e = [det.init_states(), det.init_states()]
    evs = {"g": ([], []), "e": ([], [])}
    for t in range(frames.shape[0]):
        for i, x in enumerate((frames[t], other[t])):
            g[i], ev = det.process_chunk(det.params, g[i], x)
            evs["g"][i].append(ev)
            e[i], ev = eager(det.params, e[i], x)
            evs["e"][i].append(ev)
    # one graph is kept: each turn drops the other state set's and captures
    assert det._chunk.captures == 2 * frames.shape[0]
    for i in range(2):
        stack = lambda l: Event(*[torch.stack(f) for f in zip(*l)])
        held(stack(evs["g"][i]), stack(evs["e"][i]), f"state set {i}", EV_TOL, g[i], e[i])


@pytest.mark.cuda
def test_a_host_read_raises_under_capture_and_never_falls_back(cuda_device):
    """Run last in this file: the failed capture is the point."""
    seen = []

    def step(params, states, x):
        seen.append(torch.cuda.is_current_stream_capturing())
        states[0].add_(x.sum().item())
        return states, Event(*[x[:, 0]] * 7)

    wrapped = graph.GraphedStep(step)
    states = (torch.zeros(4, device="cuda"),)
    x = torch.ones(4, 8, device="cuda")
    with pytest.raises(RuntimeError):
        wrapped(object(), states, x)
    assert seen == [False, True]  # the eager call ran; the capture raised
    assert wrapped.captures == 0 and float(states[0][0]) == 32.0
