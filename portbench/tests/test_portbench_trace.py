"""Reading a profiler trace: each device event's layer, by its name and by
the benchmark's span around the call that launched it."""
import json
import os

import pytest

from portbench import trace

KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels")


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("portbench.window", "user_annotation", 0, 1000),
    _x("portbench.process_chunk", "user_annotation", 10, 290),
    _x("cudaGraphLaunch", "cuda_runtime", 20, 5, 1),
    _x("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 100, 50, 1),
    _x("void score_pairs(float const*, int)", "kernel", 150, 100, 1),
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 260, 10, 1),
    _x("portbench.readback", "user_annotation", 300, 100),
    _x("cudaLaunchKernel", "cuda_runtime", 310, 5, 2),
    _x("void at::native::index_elementwise_kernel<128, 4>(int)", "kernel", 400, 20, 2),
    _x("cudaMemcpyAsync", "cuda_runtime", 320, 5, 3),
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 420, 30, 3),
]


@pytest.fixture
def trace_file(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return str(path)


def test_layers_by_name_and_by_launching_span(trace_file):
    table = trace.load_layers(KERNELS)
    names = {d["role"]: d["layer"] for d in
             (json.load(open(os.path.join(KERNELS, f))) for f in os.listdir(KERNELS))}
    tr = trace.parse(trace_file, table)
    got = {e.name.split("(")[0].split("<")[0]: e.layer for e in tr.events}
    assert got == {
        "void at::native::elementwise_kernel": names["bookkeeping"],
        "void score_pairs": names["k1"],
        "Memcpy DtoD ": names["copies"],
        "void at::native::index_elementwise_kernel": names["harness"],
        "Memcpy DtoH ": names["harness"],
    }
    assert tr.count("kernel") == 3 and tr.count("kernel", skip=names["harness"]) == 2
    assert (tr.start, tr.end) == (0, 1000)
    assert tr.busy_us() == 160 + 20 + 30

