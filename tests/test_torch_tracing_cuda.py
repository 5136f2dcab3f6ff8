"""The tracer on a card (`utils/tracing.py`): K1's device counters, whole
and by wakeword, against the count from its gate decisions and against the
plain version's (one wakeword at the bench shapes, three of two templates
each); a captured launch's counters still named by wakeword after tracing
is turned on again and reset; a
detector's events and states bit-equal with tracing on and off; toggling
tracing captures the chunk again exactly once; the launch counts and the
kernels a replay runs unchanged with tracing on, the spans' annotations not
among them. Every test needs a card (and nvcc, which builds K1 at first
use); without one they skip. The file imports no JAX:

    python -m pytest tests/test_torch_tracing_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.runtime.state import Event
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream
from rustpotter_tpu_torch.tools import kernel_probe
from rustpotter_tpu_torch.utils import profiling, tracing

B = 70  # three blocks of K1, the last of 6 streams


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and CUDA graphs have no CPU build")
    tracing.disable()
    tracing.reset()
    yield torch.device("cuda")
    tracing.disable()
    tracing.reset()


def _k1_counts():
    return [tracing.snapshot()["counters"].get(k, 0) for k in tracing.DEVICE_COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
def test_k1_device_counts_equal_the_plain_count(cuda_device, gate):
    """At the bench shapes (w = 5, C = 16, Lm = 100, 5 templates and their
    avg) over 300 streams: K1's four counts on the card equal the count from
    its own gate decisions and the plain version's on the CPU."""
    Bn, LENS, D, K = 300, kernel_probe.LENS, 1, len(kernel_probe.LENS) - 1
    x = kernel_probe.inputs(Bn, 4, cuda_device)
    win = x["win"].permute(1, 2, 0).contiguous()
    tset = fd.prepare_templates(x["templates"], x["tnorms"], LENS, kernel_probe.W)
    rot0 = torch.tensor(kernel_probe.LM - 2, dtype=torch.int32, device=cuda_device)
    run = lambda bounds: fd.score_chunk(win, x["new"], x["means3"], tset, bounds, D, K, rot0)
    avg = run(torch.full((D,), np.inf, device=cuda_device))[:, :, D * K:]  # (B, 3, D)
    v = avg.flatten().sort().values
    i = v.numel() // 2
    bounds = {"open": torch.full((D,), np.inf, device=cuda_device),
              "closed": (v[:1] - 1.0),
              "mixed": ((v[i - 1] + v[i]) / 2).reshape(1)}[gate]
    assert _k1_counts() == [0, 0, 0, 0]  # tracing off: no counter given
    tracing.enable()
    sims = run(bounds)
    got = _k1_counts()
    gate_open = (sims[:, :, D * K:] <= bounds).repeat_interleave(K, dim=2).permute(1, 2, 0)
    assert got == list(fd.k1_gate_counts(gate_open, LENS[:D * K]))
    on_card = tracing.snapshot()["counters"]
    assert {k: on_card[k] for k in tracing.k1_wakeword_names(0)} == \
        fd.k1_wakeword_counts(gate_open, LENS[:D * K], K)
    tracing.reset()
    cpu = lambda t: t.cpu()
    fd.score_chunk(cpu(win), cpu(x["new"]), cpu(x["means3"]),
                   fd.prepare_templates(cpu(x["templates"]), cpu(x["tnorms"]), LENS,
                                        kernel_probe.W),
                   cpu(bounds), D, K, cpu(rot0))
    assert _k1_counts() == got
    assert tracing.snapshot()["counters"] == on_card
    nb = -(-Bn // 32)
    assert got[1] == 3 * D * K * Bn and got[3] == D * K * nb
    assert got[2] == {"open": D * K * nb, "closed": 0}.get(gate, got[2])
    print(f"K1 counts, gate {gate}: {got}")


def _three_wakewords(cuda_device):
    """K1 of three wakewords of two templates (w = 5, C = 16, pairs of 100,
    80 and 60 rows in a 168-frame window) over 300 streams: `run(device)`
    on that device's copy of the operands, and gate bounds with ww0's gate
    half open, ww1's open, ww2's closed."""
    D, K, C, F, Bn, w = 3, 2, 16, 168, 300, 5
    lens = (100, 96, 80, 76, 60, 56, 100, 80, 60)
    g = torch.Generator().manual_seed(8)
    tpl = torch.randn((len(lens), 100, C), generator=g)
    x = dict(win=torch.randn((F, C, Bn), generator=g), new=torch.randn((3, C, Bn), generator=g),
             means3=0.2 * torch.randn((3, len(lens), C, Bn), generator=g),
             rot0=torch.tensor(F - 2, dtype=torch.int32))
    on = {}
    for dev in (cuda_device, torch.device("cpu")):
        d = {k: v.to(dev) for k, v in x.items()}
        d["tset"] = fd.prepare_templates(tpl.to(dev), (tpl * tpl).sum(-1).to(dev), lens, w)
        on[dev.type] = d
    run = lambda dev, bounds: fd.score_chunk(
        on[dev.type]["win"], on[dev.type]["new"], on[dev.type]["means3"], on[dev.type]["tset"],
        bounds.to(dev), D, K, on[dev.type]["rot0"])
    avg = run(cuda_device, torch.full((D,), np.inf))[:, :, D * K:].cpu()  # (B, 3, D)
    bounds = torch.tensor([float(avg[:, :, 0].flatten().median()), np.inf, -np.inf])
    return run, bounds, (D, K, Bn)


@pytest.mark.cuda
def test_k1_device_counts_by_wakeword_add_up(cuda_device):
    """Three wakewords (`_three_wakewords`): each wakeword's two counts on
    the card equal the plain version's on the CPU, and each set adds up to
    its total."""
    run, bounds, (D, K, Bn) = _three_wakewords(cuda_device)
    tracing.enable()
    run(cuda_device, bounds)
    card = tracing.snapshot()["counters"]
    tracing.reset()
    run(torch.device("cpu"), bounds)
    plain = tracing.snapshot()["counters"]
    names = [n for d in range(D) for n in tracing.k1_wakeword_names(d)]
    assert set(card) == set(plain) == set(tracing.DEVICE_COUNTERS) | set(names)
    assert card == plain
    for i, total in ((0, "k1.lanes_open"), (1, "k1.blocks_run")):
        assert sum(card[tracing.k1_wakeword_names(d)[i]] for d in range(D)) == card[total]
    lanes = 3 * K * Bn
    opened = [card[tracing.k1_wakeword_names(d)[0]] for d in range(D)]
    assert 0 < opened[0] < lanes and opened[1] == lanes and opened[2] == 0
    print(f"K1 counts by wakeword: {card}")


@pytest.mark.cuda
def test_k1_counts_by_wakeword_outlive_enable_and_reset(cuda_device):
    """A captured K1 launch of three wakewords, replayed after tracing is
    turned on again and reset with no eager launch between, still has its
    counters named by wakeword: the width is kept with the card's counter
    tensor. Two replays count twice one replay, and each set adds up to its
    total."""
    run, bounds, (D, K, _) = _three_wakewords(cuda_device)
    bounds = bounds.to(cuda_device)
    tracing.enable()
    run(cuda_device, bounds)  # makes the counters before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(cuda_device, bounds)
    tracing.reset()
    graph.replay()
    once = tracing.snapshot()["counters"]
    tracing.enable()
    tracing.reset()
    graph.replay()
    graph.replay()
    twice = tracing.snapshot()["counters"]
    names = [n for d in range(D) for n in tracing.k1_wakeword_names(d)]
    assert set(once) == set(twice) == set(tracing.DEVICE_COUNTERS) | set(names)
    assert twice == {k: 2 * v for k, v in once.items()}
    for i, total in ((0, "k1.lanes_open"), (1, "k1.blocks_run")):
        assert sum(twice[tracing.k1_wakeword_names(d)[i]] for d in range(D)) == twice[total] > 0


def _detector(ww):
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    return BatchedDetector([("w", ww)], cfg, batch_size=B, device="cuda")


def _frames(ww, utterance):
    s0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(5).normal(0, 0.05, (len(s0), B, 480)).astype(np.float32)
    frames[:, 0] = s0
    return torch.tensor(frames, device="cuda")


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ww, utterance = build_bench_wakeword(device="cuda")
    return ww, _frames(ww, utterance)


def _run(det, frames, trace):
    (tracing.enable if trace else tracing.disable)()
    states, evs = det.init_states(), []
    for t in range(frames.shape[0]):
        states, ev = det.process_chunk(det.params, states, frames[t])
        evs.append(ev)
    torch.cuda.synchronize()
    return states, Event(*[torch.stack(f) for f in zip(*evs)])


def _bits(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
def test_events_are_bit_equal_with_tracing_on_and_off(cuda_device, bench):
    ww, frames = bench
    s_off, ev_off = _run(_detector(ww), frames, trace=False)
    s_on, ev_on = _run(_detector(ww), frames, trace=True)
    assert bool(ev_off.fired[:, 0].any())
    assert all(_bits(a, b) for a, b in zip(ev_on, ev_off))
    assert all(_bits(a, b) for a, b in zip(s_on, s_off))
    # every chunk's gated launch counted: 5 template pairs x 3 blocks each
    lanes_open, lanes, blocks_run, blocks = _k1_counts()
    T = frames.shape[0]
    assert (lanes, blocks) == (T * 3 * 5 * B, T * 5 * 3) and 0 < lanes_open <= lanes
    assert 0 < blocks_run <= blocks
    names = [s["name"] for s in tracing.snapshot()["spans"]]
    assert names.count("rustpotter.process_chunk") == T
    assert names.count("rustpotter.graph.replay") == T - 1
    assert names.count("rustpotter.graph.eager") == names.count("rustpotter.graph.capture") == 1


@pytest.mark.cuda
def test_toggling_tracing_captures_again_exactly_once(cuda_device, bench):
    ww, frames = bench
    det = _detector(ww)
    states = det.init_states()
    step = lambda s, t: det.process_chunk(det.params, s, frames[t])[0]
    for t in range(3):
        states = step(states, t)
    assert det._chunk.captures == 1
    tracing.enable()
    for t in range(3, 6):
        states = step(states, t)
    assert det._chunk.captures == 2
    names = [s["name"] for s in tracing.snapshot()["spans"]]
    assert names.count("rustpotter.graph.capture") == 1
    assert names.count("rustpotter.graph.replay") == 2
    tracing.disable()
    for t in range(6, 9):
        states = step(states, t)
    assert det._chunk.captures == 3


@pytest.mark.cuda
def test_launches_per_replay_are_unchanged_with_tracing_on(cuda_device, bench):
    ww, frames = bench
    det = _detector(ww)
    states = det.init_states()
    replay = lambda: det.process_chunk(det.params, states, frames[0])
    seen = {}
    for trace in (False, True):
        (tracing.enable if trace else tracing.disable)()
        replay()  # the capture for this state of the tracer
        before = dict(fd.LAUNCHES)
        for _ in range(4):
            replay()
        counted = {k: v - before[k] for k, v in fd.LAUNCHES.items() if v != before[k]}
        seen[trace] = (counted, profiling.profiled_launches(replay, 3))
    assert seen[True][0] == seen[False][0] == {"fused_dtw_v4": 4}
    assert seen[True][1][0] == seen[False][1][0] == {"fused_dtw_v4": 2, "mfcc_prologue": 1,
                                                     "mfcc_epilogue": 1}
    # the spans' device-side ranges are no kernels
    assert not [r for r in profiling.device_kernels(replay, 3) if r[2].startswith("rustpotter.")]
    print(f"a replay's device kernels and copies: {seen[False][1][1]} off, {seen[True][1][1]} on")
