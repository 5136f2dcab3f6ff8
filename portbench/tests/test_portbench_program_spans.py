"""The reader of the program's own feed span (`metrics/feed_host_ms.py`) on a
synthetic trace, on a trace without it (a program that records none), and on
a CPU run's profiled sub-window; and the idle gaps of a profile named by the
program's spans."""
import pytest

from portbench import harness, trace

from test_portbench_reference import run_cpu


def _data(host, chunks=2, start=0.0, end=1000.0):
    tr = trace.Trace([], host, start, end, chunks)
    return harness.RunData(None, harness.Window(), tr, {}, [], 0.0, None, {})


# two served chunks, and spans outside the profiled window that no reader counts
HOST = [
    ("portbench.window", 0.0, 1000.0),
    ("rustpotter.feed", -50.0, -10.0),
    ("portbench.process_chunk", 10.0, 400.0),
    ("rustpotter.process_chunk", 12.0, 398.0),
    ("rustpotter.feed", 15.0, 80.0),
    ("rustpotter.graph", 85.0, 395.0),
    ("rustpotter.graph.key", 86.0, 120.0),
    ("rustpotter.graph.replay", 121.0, 300.0),
    ("cudaGraphLaunch", 200.0, 290.0),
    ("portbench.process_chunk", 500.0, 900.0),
    ("rustpotter.process_chunk", 502.0, 898.0),
    ("rustpotter.feed", 505.0, 580.0),
    ("rustpotter.graph", 585.0, 885.0),
    ("cudaGraphLaunch", 700.0, 800.0),
    ("rustpotter.feed", 1010.0, 1090.0),
    ("cudaGraphLaunch", 1100.0, 1150.0),
]


def test_the_feed_reader_averages_over_the_windows_chunks():
    run = _data(HOST)
    assert harness.read_metric("feed_host_ms.serve", run) == pytest.approx((65 + 75) / 2 / 1e3)


def test_the_feed_reader_reads_nothing_without_the_programs_spans():
    bare = [h for h in HOST if not h[0].startswith("rustpotter.")]
    assert harness.read_metric("feed_host_ms.serve", _data(bare)) is None
    assert harness.read_metric("feed_host_ms.serve", _data(HOST, chunks=0)) is None
    assert harness.read_metric("feed_host_ms.serve", harness.RunData(
        None, harness.Window(), None, {}, [], 0.0, None, {})) is None


def test_an_idle_gap_is_named_by_the_innermost_program_span():
    events = [trace.DeviceEvent("score_pairs", "kernel", 0.0, 100.0),
              trace.DeviceEvent("score_pairs", "kernel", 300.0, 1000.0)]
    tr = trace.Trace(events, HOST, 0.0, 1000.0, 2)
    assert tr.breakdown()["idle_gaps"] == [["rustpotter.graph.key", pytest.approx(200e-6)]]


def test_a_traced_cpu_run_reads_the_programs_feed_span():
    res = run_cpu("dtw_bench.serve", traced=True)
    assert res["correct"]
    assert res["metrics"]["feed_host_ms.serve"]["value"] > 0
