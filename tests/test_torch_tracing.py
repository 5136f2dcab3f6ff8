"""The port's tracer (`utils/tracing.py`) on the CPU: off, one shared no-op
context and nothing recorded; on, the spans of `BatchedDetector`'s
`process_chunk` and `process_sequence` with their parents and chunk ids;
self time; the tracer's state in the capture key; the plain K1's gate
counts, whole and by wakeword, against a direct count of the gate
decisions; the bundle build's span; and the spans in a
torch.profiler trace with tracing off. The card's side (K1's device
counters, graphs with tracing on): tests/test_torch_tracing_cuda.py.

Workload: the 30-frame bench wakeword (5 templates and their average, one
wakeword) at B = 4, seeded noise frames.
"""
import json
import os

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import RustpotterConfig
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime import graph
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.synthetic import build_bench_wakeword
from rustpotter_tpu_torch.utils import tracing

B = 4


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def detector_parts():
    ww, _ = build_bench_wakeword(device="cpu", longest=30)
    frames = np.random.default_rng(3).normal(0, 0.05, (4, B, 480)).astype(np.float32)
    return ww, frames


def _detector(ww):
    return BatchedDetector([("w", ww)], RustpotterConfig(), batch_size=B, device="cpu")


def _tree(snap):
    """(name, parent's name, chunk) of each span, in the order they opened."""
    spans = snap["spans"]
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"], s["chunk"])
            for s in spans]


def test_off_a_span_is_one_shared_no_op_and_nothing_is_recorded(detector_parts):
    ww, frames = detector_parts
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b", chunk=3)
    with tracing.span("a") as got:
        assert got is None
    det = _detector(ww)
    states = det.init_states()
    states, _ = det.process_chunk(det.params, states, frames[0])
    det.process_sequence(det.params, states, frames[1:3])
    tracing.count("k1.lanes", 5)
    assert tracing.snapshot() == {"spans": [], "dropped": 0, "counters": {}}


def test_process_chunk_spans_nest_and_share_the_chunk_id(detector_parts):
    ww, frames = detector_parts
    det = _detector(ww)
    states = det.init_states()
    tracing.enable()
    for t in range(2):
        states, _ = det.process_chunk(det.params, states, frames[t])
    snap = tracing.snapshot()
    per_chunk = lambda c: [("rustpotter.process_chunk", None, c),
                           ("rustpotter.feed", "rustpotter.process_chunk", c),
                           ("rustpotter.graph", "rustpotter.process_chunk", c),
                           ("rustpotter.graph.eager", "rustpotter.graph", c)]
    assert _tree(snap) == per_chunk(0) + per_chunk(1)
    for s in snap["spans"]:
        assert s["start_ns"] <= s["end_ns"] and 0 <= s["self_ns"] <= s["end_ns"] - s["start_ns"]
    # the plain K1 counted its gated launch: 3 shifts x 5 template pairs x B
    # streams a chunk, one block of 32 streams per pair
    counters = snap["counters"]
    assert counters["k1.lanes"] == 2 * 3 * 5 * B and counters["k1.blocks"] == 2 * 5
    assert 0 <= counters["k1.lanes_open"] <= counters["k1.lanes"]
    assert 0 <= counters["k1.blocks_run"] <= counters["k1.blocks"]


def test_a_sequences_per_chunk_spans_carry_their_own_chunk_id(detector_parts):
    ww, frames = detector_parts
    det = _detector(ww)
    states = det.init_states()
    states, _ = det.process_chunk(det.params, states, frames[0])  # chunk 0, untraced
    tracing.enable()
    states, ev = det.process_sequence(det.params, states, frames[1:4])
    assert ev.fired.shape == (3, B)
    assert _tree(tracing.snapshot()) == [
        ("rustpotter.process_sequence", None, 1),
        ("rustpotter.feed", "rustpotter.process_sequence", 1),
        ("rustpotter.graph", "rustpotter.process_sequence", 1),
        ("rustpotter.graph.eager", "rustpotter.graph", 1),
        ("rustpotter.graph.eager", "rustpotter.graph", 2),
        ("rustpotter.graph.eager", "rustpotter.graph", 3),
    ]
    det.process_chunk(det.params, states, frames[0])
    assert tracing.snapshot()["spans"][-4]["chunk"] == 4


def test_self_time_is_the_span_less_its_children(monkeypatch):
    ticks = iter([0, 10, 15, 20, 26, 40, 100, 103])
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    tracing.enable()
    with tracing.span("a", chunk=7):
        with tracing.span("b"):
            pass
        with tracing.span("c", offset=2):
            with tracing.span("d"):
                pass
    spans = tracing.snapshot()["spans"]
    assert [(s["name"], s["start_ns"], s["end_ns"], s["parent"], s["chunk"], s["self_ns"])
            for s in spans] == [("a", 0, 103, None, 7, 103 - 5 - 80),
                                ("b", 10, 15, 0, 7, 5),
                                ("c", 20, 100, 0, 9, 80 - 14),
                                ("d", 26, 40, 2, 9, 14)]


def test_the_ring_keeps_the_newest_spans_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.reset()
    tracing.enable()
    with tracing.span("a", chunk=1):
        with tracing.span("b"):
            pass
        with tracing.span("c"):
            with tracing.span("d"):
                pass
    snap = tracing.snapshot()
    # "a" went first; its children keep their chunk id, and read no parent
    assert _tree(snap) == [("b", None, 1), ("c", None, 1), ("d", "c", 1)]
    assert snap["dropped"] == 1
    assert snap["spans"][1]["self_ns"] == (snap["spans"][1]["end_ns"] - snap["spans"][1]["start_ns"]
                                           - snap["spans"][2]["end_ns"] + snap["spans"][2]["start_ns"])
    tracing.reset()
    assert tracing.snapshot()["dropped"] == 0


def test_a_reset_inside_a_span_keeps_the_stack_whole():
    tracing.enable()
    with tracing.span("outer"):
        tracing.reset()
        with tracing.span("inner"):
            pass
    with tracing.span("next"):
        pass
    assert [(s["name"], s["parent"]) for s in tracing.snapshot()["spans"]] == [
        ("inner", None), ("next", None)]


def test_capture_key_holds_the_tracers_state(detector_parts):
    ww, frames = detector_parts
    det = _detector(ww)
    states = det.init_states()
    x = torch.tensor(frames[0])
    off = graph.capture_key(det.params, states, x)
    tracing.enable()
    on = graph.capture_key(det.params, states, x)
    tracing.disable()
    assert on != off and graph.capture_key(det.params, states, x) == off


def _k1_inputs(Bn, seed):
    """K1's operands at D = 2 wakewords of K = 2 templates, w = 3."""
    rng = np.random.default_rng(seed)
    LM, C, F, D, K = 12, 4, 14, 2, 2
    P = D * K + D
    lens = (12, 9, 10, 2, 12, 11)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    tpl = rng.normal(0, 1, (P, LM, C))
    x = dict(win=t(rng.normal(0, 1, (F, C, Bn))), new=t(rng.normal(0, 1, (3, C, Bn))),
             means3=t(rng.normal(0, 0.2, (3, P, C, Bn))),
             tset=fd.prepare_templates(t(tpl), t(np.sum(tpl ** 2, axis=-1)), lens, 3),
             rot0=torch.tensor(F - 2, dtype=torch.int32))
    return x, lens, D, K


def test_plain_k1_counts_equal_a_direct_count_of_its_gate_decisions():
    """A fleet of 70 streams (3 blocks a pair, the last of 6 streams): ww0's
    gate between two of its avg sims (open and closed lanes, blocks that
    work), ww1's closed (blocks that do not)."""
    Bn = 70
    x, lens, D, K = _k1_inputs(Bn, seed=21)
    lin = fd.virtual_windows(x["win"], x["new"], x["rot0"], x["tset"].tp.shape[1])
    sims = fd._band_sims(lin, x["means3"], x["tset"].tp, lens, x["tset"].band)  # (3, P, B)
    avg = sims[:, D * K:]
    bounds = torch.stack([avg[:, 0].flatten().median(), torch.tensor(-np.inf)])
    tracing.enable()
    fd.score_chunk(x["win"], x["new"], x["means3"], x["tset"], bounds, D, K, x["rot0"])
    got = tracing.snapshot()["counters"]
    # the direct count: lane (shift s, template pair p, stream b) is open when
    # its wakeword's avg sim is at most the bound; a block is 32 streams x 3
    # shifts of one pair
    avg_h, bounds_h = avg.numpy(), bounds.numpy()
    lanes_open = lanes = blocks_run = blocks = 0
    per_ww = [[0, 0] for _ in range(D)]  # open lanes, blocks that work
    for p in range(D * K):
        d = p // K
        for b0 in range(0, Bn, 32):
            opened = [avg_h[s, d, b] <= bounds_h[d] for s in range(3)
                      for b in range(b0, min(b0 + 32, Bn))]
            lanes_open += sum(opened)
            lanes += len(opened)
            blocks_run += any(opened) and lens[p] >= 2
            blocks += 1
            per_ww[d][0] += sum(opened)
            per_ww[d][1] += any(opened) and lens[p] >= 2
    assert blocks == D * K * 3 and 0 < blocks_run < blocks and 0 < lanes_open < lanes
    assert [got[k] for k in tracing.DEVICE_COUNTERS] == [lanes_open, lanes, blocks_run, blocks]
    # by wakeword: ww0's gate half open, ww1's closed; each set adds up
    assert [[got[k] for k in tracing.k1_wakeword_names(d)] for d in range(D)] == per_ww
    assert per_ww[0][0] > 0 and per_ww[1] == [0, 0]
    for i, total in ((0, "k1.lanes_open"), (1, "k1.blocks_run")):
        assert sum(got[tracing.k1_wakeword_names(d)[i]] for d in range(D)) == got[total]


def test_the_bundle_build_is_one_span_per_build(detector_parts):
    """`rustpotter.bundle`: a root span at set-up and at every rebuild."""
    ww, frames = detector_parts
    tracing.enable()
    det = _detector(ww)
    states = det.init_states()
    states = det.add_wakeword("v", ww, states)
    states, _ = det.process_chunk(det.params, states, frames[0])
    states = det.remove_wakeword("v", states)
    det.update_detector_config(det.config.detector, states)
    spans = tracing.snapshot()["spans"]
    bundles = [s for s in spans if s["name"] == "rustpotter.bundle"]
    assert len(bundles) == 4
    assert all(s["parent"] is None and s["chunk"] is None and s["self_ns"] >= 0 for s in bundles)


def test_a_profile_holds_the_spans_with_tracing_off(tmp_path):
    """Under torch.profiler a span is a `user_annotation` of the Chrome
    trace, also with tracing off; the tracer records nothing then."""
    from torch.profiler import ProfilerActivity, profile

    step = graph.GraphedStep(lambda params, states, x: (states, x + 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("rustpotter.process_chunk", chunk=0):
            step(None, (), torch.zeros(4))
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    names = {e["name"] for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"rustpotter.process_chunk", "rustpotter.graph", "rustpotter.graph.eager"} <= names
    assert tracing.snapshot()["spans"] == []
