"""The port's serving paths as CUDA graphs on a card (`runtime/graph.py`):
each graphed entry point against the eager function on the same audio,
over the correctness stream of the bench wakeword (stream 0 the utterance,
the rest seeded noise): `BatchedDetector` (the DTW chunk, `nn_medium`,
`mixed`, the benchmark's `mixed` deployment at B = 8192 (three DTW
wakewords of 8 templates and a LARGE NN wakeword, 168 frames), the filters,
48 kHz in-graph resampling; `process_sequence`; a live
`add_wakeword`, `reset_streams`, `update_filters_config`; two state sets in
turns), `make_step` in its K2, K4 and K3 modes and with the filters on, and
`Rustpotter` (the bench
wakeword, `mixed`, the filters, 48 kHz int16 through the host encoder:
`process_samples`, `process_audio_sequence`, held to `make_step`'s events and
to a `Rustpotter` on the CPU); the kernels each launches, exactly, its launch
count per replay, and the kernels a replay runs as torch.profiler sees
them. The batched chunk, `make_step` and the management calls run at
B = 64 and at the bench's B = 8192, and hold streams 0-3 to the same calls
on the CPU at B = 4 (the `mixed` deployment only graphed against eager); a
detector on a card other than the current one
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
from rustpotter_tpu_torch.audio.encoder import AudioEncoder
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
BENCH_B = 8192  # the bench's streams
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


def launched_since(before):
    """The launches counted since `counts()` read `before`, of the kernels
    that launched."""
    return {k: v - before[k] for k, v in counts().items() if v != before[k]}


def run(process, states, frames):
    """process(states, x) over frames (T, ...): (the final states, the
    Events stacked (T, B, ...), the launches counted)."""
    before = counts()
    evs = []
    for t in range(frames.shape[0]):
        states, ev = process(states, frames[t])
        evs.append(ev)
    if frames.is_cuda:
        torch.cuda.synchronize(frames.device)
    return states, Event(*[torch.stack(f) for f in zip(*evs)]), launched_since(before)


def streams_0_to_3(ev):
    """The Events of streams 0-3, on the CPU."""
    return Event(*[f[:, :4].cpu() for f in ev])


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
    B = BENCH_B, its wakewords made by the benchmark from a seed, and the
    frames of its first utterance."""
    from portbench import harness, synth
    from portbench import wakewords as bench_ww

    conf = harness.load_json(harness.ROOT, "portbench", "configs", "mixed.json")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    objs, cfg = bench_ww.for_program(bench_ww.build(conf, gen, torch.device("cuda")), conf)
    det = BatchedDetector(objs, cfg, batch_size=BENCH_B, device="cuda")
    utt = synth.utterances(conf["wakewords"][0]["utterances"])[0]
    return det, stream_frames(utt, det.static.max_mfcc_frames, b=BENCH_B), NN_TOL


def widths(cases):
    """The cases at B, ids the case's name, then at BENCH_B, ids
    "<case>-8192"."""
    return ([pytest.param(c, B, id=c) for c in cases]
            + [pytest.param(c, BENCH_B, id=f"{c}-{BENCH_B}") for c in cases])


def on_the_cpu(det, frames):
    """The same detector on the CPU at B = 4 over streams 0-3 of `frames`:
    (its final states, its Events)."""
    cpu = BatchedDetector(det._wakewords, det.config, batch_size=4, device="cpu",
                          in_graph_resample=det._in_graph_resample)
    states, ev, _ = run(lambda s, x: cpu.process_chunk(cpu.params, s, x), cpu.init_states(),
                        frames[:, :4].cpu())
    return states, ev


def gains_held(ev, states, ev_cpu, states_cpu):
    """The event gains and the final gains of streams 0-3 equal the CPU's to
    the bit (NaN for NaN)."""
    for card, cpu in ((ev.gain[:, :4].cpu(), ev_cpu.gain), (states.gain[:4].cpu(),
                                                            states_cpu.gain)):
        torch.testing.assert_close(card, cpu, rtol=0, atol=0, equal_nan=True)


def batched_case(words, case, b=B):
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
    det = BatchedDetector(wakewords, cfg, batch_size=b, device="cuda",
                          in_graph_resample=resample)
    u = utterance if n == 480 else bench_utterances(100, 48000)[0]
    return det, stream_frames(u, det.static.max_mfcc_frames, n, b=b), tol


@pytest.mark.cuda
@pytest.mark.parametrize("case, b", widths(["dtw", "nn_medium", "mixed", "filtered", "48k"])
                         + [pytest.param("mixed_fleet", BENCH_B, id="mixed_fleet")])
def test_batched_chunk_graph_equals_eager(cuda_device, words, case, b):
    """Graphed against eager on the card, then (but the `mixed` deployment)
    streams 0-3 against the same detector on the CPU at B = 4: events, and
    the event and final gains to the bit."""
    det, frames, tol = batched_case(words, case, b)
    eager = make_batched_chunk(det.static)
    sg, evg, lg = run(lambda s, x: det.process_chunk(det.params, s, x), det.init_states(), frames)
    se, eve, le = run(lambda s, x: eager(det.params, s, x), det.init_states(), frames)
    assert det._chunk.captures == 1
    assert lg == le, (lg, le)  # launches counted per replay, as the eager run's
    T = frames.shape[0]
    want = {"fused_dtw_v4": T if det.static.n_dtw else 0,
            "biquad": T if case == "filtered" else 0, "mfcc_prologue": T, "mfcc_epilogue": T}
    assert lg == {k: v for k, v in want.items() if v}, lg  # and no other kernel
    assert bool(evg.fired[:, 0].any()), case
    held(evg, eve, case, tol, sg, se)
    # process_sequence: T replays of a graph of its own state set
    ss, evs = det.process_sequence(det.params, det.init_states(), frames)
    held(evs, evg, f"{case} process_sequence", tol, ss, sg)
    if case == "dtw":  # the same kernels on the same states: the same bits
        assert all(bits(a, b) for a, b in zip(evs, evg))
    replays_run(lambda: det.process_chunk(det.params, sg, frames[-1]),
                lambda: eager(det.params, se, frames[-1]), lg, frames.shape[0], case)
    if case != "mixed_fleet":
        sc, evc = on_the_cpu(det, frames)
        held(streams_0_to_3(evg), evc, f"{case} at B = {b} against the cpu", tol)
        gains_held(evg, sg, evc, sc)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, b", widths(["K2", "K4", "K3", "filtered"]))
def test_make_step_graph_equals_eager(cuda_device, words, mode, b):
    """Graphed against eager on the card, then streams 0-3 against the same
    step on the CPU (events; the event gains and the final gains to the bit,
    NaN for NaN). "filtered": the K2 mode with the gain normalizer and the
    band-pass on."""
    ww, _, utterance = words
    cfg, opts = config(filters=mode == "filtered"), {"dtw_fused": False} if mode == "K3" else {}
    static, params = build_bundle([("w", ww)], cfg, "cuda", **opts)
    _, params_cpu = build_bundle([("w", ww)], cfg, "cpu", **opts)
    if mode == "K4":
        static = dataclasses.replace(static, dtw_fused_variant=2)
    kernel = {"K4": "fused_dtw_v2", "K3": "banded_dtw"}.get(mode, "fused_dtw_v3")
    frames = stream_frames(utterance, static.max_mfcc_frames, b=b)
    T = frames.shape[0]
    step = graph.GraphedStep(make_step(static))
    eager = make_step(static)
    sg, evg, lg = run(lambda s, x: step(params, s, x), init_state(static, b, "cuda"), frames)
    se, eve, le = run(lambda s, x: eager(params, s, x), init_state(static, b, "cuda"), frames)
    want = {kernel: 3 * T, "mfcc_epilogue": 3 * T, **({"biquad": T} if mode == "filtered" else {})}
    assert lg == le == want, (lg, le)
    assert step.captures == 1 and bool(evg.fired[:, 0].any())
    held(evg, eve, f"make_step {mode}", EV_TOL, sg, se)
    replays_run(lambda: step(params, sg, frames[-1]), lambda: eager(params, se, frames[-1]),
                lg, T, f"make_step {mode}")
    sc, evc, _ = run(lambda s, x: eager(params_cpu, s, x), init_state(static, 4, "cpu"),
                     frames[:, :4].cpu())
    held(streams_0_to_3(evg), evc, f"make_step {mode} at B = {b} against the cpu", EV_TOL)
    gains_held(evg, sg, evc, sc)


def rustpotter(wakewords, cfg, device):
    rp = Rustpotter(copy.deepcopy(cfg), device=device)
    for key, ww in wakewords:
        rp.add_wakeword(key, ww)
    return rp


def _detections(rp, frames):
    """[(frame index, detection)] of `process_samples` over frames in the
    configured format."""
    out = []
    for i, frame in enumerate(frames):
        d = rp.process_samples(frame)
        if d is not None:
            out.append((i, d))
    return out


def rustpotter_held(wakewords, cfg, frames, device, tol=EV_TOL):
    """Raises unless a graphed Rustpotter on `device` over `frames` (in the
    configured format) detects at the frames where `make_step` at B = 1
    fires on the host encoder's output, with its counter, gain and scores,
    and as a Rustpotter on the CPU does, names and score labels too;
    launches K2 and the MFCC epilogue 3 times a frame (and the front-end
    kernel once with a filter on), no other kernel; a replay runs the eager
    step's kernels (`replays_run`); then `process_audio_sequence` over the
    encoded frames after a reset gives the same detections and launches
    without capturing again. Returns the detections."""
    rp = rustpotter(wakewords, cfg, device)
    static, params = build_bundle(wakewords, cfg, device)
    n = len(frames)
    launches = {"fused_dtw_v3": 3 * n, "mfcc_epilogue": 3 * n,
                **({"biquad": n} if static.gain_enabled or static.bp_enabled else {})}
    before = counts()
    got = _detections(rp, frames)
    assert launched_since(before) == launches
    encoder = AudioEncoder(cfg.fmt)
    encoded = [encoder.rencode_and_resample(frame) for frame in frames]
    step, state, evs = make_step(static), init_state(static, 1, device), []
    for frame in encoded:
        state, ev = step(params, state, torch.as_tensor(frame, device=device).reshape(1, -1))
        evs.append(ev)
    want = Event(*[torch.cat(f).cpu() for f in zip(*evs)])
    cpu = _detections(rustpotter(wakewords, cfg, "cpu"), frames)
    assert got and [i for i, _ in got] == torch.nonzero(want.fired)[:, 0].tolist()
    assert [i for i, _ in cpu] == [i for i, _ in got]
    for (i, d), (_, c) in zip(got, cpu):
        assert (d.name, d.counter, list(d.scores)) == (c.name, c.counter, list(c.scores))
        assert d.counter == int(want.counter[i])
        np.testing.assert_equal(np.float32(d.gain), want.gain[i].numpy())  # NaN = NaN
        np.testing.assert_equal(np.float32(d.gain), np.float32(c.gain))
        values = [d.score, d.avg_score, *d.scores.values()]
        np.testing.assert_allclose(values, [float(want.score[i]), float(want.avg_score[i]),
                                            *want.scores[i, :len(d.scores)].tolist()], **tol)
        np.testing.assert_allclose(values, [c.score, c.avg_score, *c.scores.values()], **tol)
    x = torch.as_tensor(encoded[n // 2], device=device).reshape(1, -1)
    replays_run(lambda: rp.process_samples(frames[n // 2]), lambda: step(params, state, x),
                launches, n, "Rustpotter", device)
    captures = rp._step.captures
    rp.reset()  # in place: the graph stays
    before = counts()
    seq = rp.process_audio_sequence(np.concatenate(encoded))
    assert launched_since(before) == launches
    assert rp._step.captures == captures == 1
    assert [(d.name, d.counter, d.score) for d in seq] == [
        (d.name, d.counter, d.score) for _, d in got]
    return got


def rustpotter_case(words, case):
    """(wakewords, config, frames, score tolerance) of a Rustpotter case:
    the bench wakeword; `mixed` (with the firing NN wakeword); the gain
    normalizer and band-pass on; 48 kHz int16 input (the utterance
    synthesized at 48 kHz), resampled by the host encoder."""
    ww, firing, utterance = words
    wakewords = [("w", ww)] + ([("n", firing)] if case == "mixed" else [])
    cfg = config(filters=case == "filtered")
    frames = correctness_stream(firing.train_size if case == "mixed" else 100, utterance)
    if case == "48k_i16":
        cfg.fmt = AudioFmt(sample_rate=48000, sample_format=SampleFormat.I16)
        s48 = correctness_stream(100, bench_utterances(100, 48000)[0], 1440)
        frames = np.clip(np.round(s48 * 32767.0), -32768, 32767).astype(np.int16)
    return wakewords, cfg, frames, NN_TOL if case == "mixed" else EV_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtw", "mixed", "filtered", "48k_i16"])
def test_rustpotter_graph_equals_eager(cuda_device, words, case):
    wakewords, cfg, frames, tol = rustpotter_case(words, case)
    rustpotter_held(wakewords, cfg, frames, "cuda", tol)


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
    rustpotter_held([("w", ww)], config(), correctness_stream(100, utterance), dev)
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


def _management(det, firing, frames, eager_of):
    """`frames` (T, B, 480) on det's device through `det` with management
    calls on the way: the filters turned on at chunk 5, the NN wakeword
    `firing` added at 10, streams 1 and 2 reset at 30 (all before the
    utterance, so that the window refills and stream 0 fires). With eager_of
    None, det's graphed chunk (its plain chunk on the CPU); else
    eager_of(static) per rebuild. Returns the final states and the events."""
    device = frames.device
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
@pytest.mark.parametrize("b", [B, BENCH_B])
def test_graph_after_add_wakeword_reset_and_filters_change(cuda_device, words, b):
    """Graphed against eager on the card at B = b, then streams 0-3 against
    the same calls on the CPU at B = 4."""
    ww, firing, utterance = words
    frames = stream_frames(utterance, firing.train_size, b=b)
    runs = []
    for eager_of, x in ((None, frames), (make_batched_chunk, frames),
                        (None, frames[:, :4].cpu())):
        det = BatchedDetector([("w", ww)], config(), batch_size=x.shape[1], device=x.device)
        runs.append(_management(det, firing, x, eager_of))
        if eager_of is None and x.is_cuda:
            # the rebuilds captured again: the last one once, at its first chunk
            assert det._chunk.captures == 1 and det.static.gain_enabled
    (sg, evg), (se, eve), (_, evc) = runs
    assert bool(evg.fired[:, 0].any())
    held(evg, eve, "management", NN_TOL, sg, se)
    held(streams_0_to_3(evg), evc, "management against the cpu", NN_TOL)


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
