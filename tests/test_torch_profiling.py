"""rustpotter_tpu_torch.utils.profiling against the JAX package's
utils/profiling.py: the step roofline counts field by field for the same
wakeword, the H100 chip spec, the trace context on the CPU, the work
counts that the tools divide by the peaks, and the kernel
names that `profiled_launches` keys by wrapper."""
import json
import os
import re

import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.utils.profiling import step_roofline as jax_step_roofline
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import RustpotterConfig, WakewordRef
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.utils import profiling


def _features(seed, n_templates=5, frames=90, C=16):
    rng = np.random.default_rng(seed)
    return ({f"s{i}": rng.normal(0, 1, (frames - 2 * i, C)).astype(np.float32)
             for i in range(n_templates)}, rng.normal(0, 1, (frames, C)).astype(np.float32))


@pytest.mark.parametrize("n_words,band", [(1, 5), (2, 3)])
def test_step_roofline_equals_jax_field_by_field(n_words, band):
    jax_ww, ww = [], []
    for d in range(n_words):
        samples, avg = _features(d, n_templates=5 - d)
        jax_ww.append((f"w{d}", JaxWakewordRef(name=f"w{d}", samples_features=samples,
                                                avg_features=avg, rms_level=0.05)))
        ww.append((f"w{d}", WakewordRef(name=f"w{d}", samples_features=samples,
                                        avg_features=avg, rms_level=0.05)))
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.band_size = cfg.detector.band_size = band
    jstatic, _ = jax_build_bundle(jax_ww, jcfg)
    static, _ = build_bundle(ww, cfg, device="cpu")
    want = jax_step_roofline(jstatic)
    got = profiling.step_roofline(static)
    assert (got.gemm_flops, got.vector_flops, got.hbm_bytes) == (
        want.mxu_flops, want.vpu_flops, want.hbm_bytes)
    assert got.gemm_flops > 0 and got.vector_flops > 0 and got.hbm_bytes > 0
    sol = profiling.streams_speed_of_light(static)
    assert sol == pytest.approx(0.03 / got.seconds_bound(profiling.H100))
    assert sol > 1000  # the op structure allows >1k realtime streams per card


def test_chip_spec_is_the_data_sheet_until_measured():
    chip = profiling.H100
    assert (chip.fp32_tflops, chip.hbm_gbps, chip.fp32_fma_tflops_measured) == (67.0, 3350.0,
                                                                                 None)
    ms, by = profiling.bound(67e9, 1.0)  # 1 ms of fp32 at the peak, a byte
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = profiling.bound(1.0, 3.35e9)
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    """The exporter: trace.json with the program's spans as user
    annotations, spans.json with the tracer's spans and counters and the
    wrappers' launch counts; tracing on inside, off again after."""
    from rustpotter_tpu_torch.ops import fused_dtw
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.utils import tracing

    step = GraphedStep(lambda params, states, x: (states, x.cumsum(0)))
    tracing.disable()
    with profiling.trace(str(tmp_path / "t")):
        assert tracing.enabled()
        step(None, (), torch.ones(64))
        tracing.count("k1.lanes", 3)
    assert not tracing.enabled()
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rustpotter.graph", "rustpotter.graph.eager"} <= names
    with open(os.path.join(tmp_path, "t", "spans.json")) as f:
        spans = json.load(f)
    assert [(s["name"], s["parent"]) for s in spans["spans"]] == [
        ("rustpotter.graph", None), ("rustpotter.graph.eager", 0)]
    assert spans["counters"] == {"k1.lanes": 3}
    assert spans["launches"]["fused_dtw"] == fused_dtw.LAUNCHES
    assert set(spans["launches"]) == {"fused_dtw", "banded_dtw", "biquad", "frontend"}
    tracing.reset()


def test_dtw_work_counts():
    # bench shapes: the K1 bound of PERF.md (3.8724 GFLOP), and K4's per-pair
    # count against a direct count of its valid band cells
    dots, rest = profiling.k1_work((100, 98, 96, 94, 92, 100), 5, 16, 8192)
    assert (dots + rest) / 1e9 == pytest.approx(3.8724, abs=5e-5)
    n, w, C = 20, 5, 8
    cells = sum(1 for r in range(1, n) for j in range(2 * w) if 1 <= r - w + j <= n)
    per_row = 2 * (2 * w) + 2 * (2 * w - 1) + 2 * C  # DP and the dotm chain
    assert profiling.dp_work(n, w, C, True) == (n * (3 * C + 1) + (2 * C + 3) * cells
                                                + (n - 1) * per_row)
    assert profiling.dp_work(1, w, C, True) == 0
    assert profiling.linear_bytes(100, 16, 8192, 6) < profiling.shift_bytes(100, 16, 8192, 6, 1)


# ptxas's report for K1's C = 16 build, as nvcc -Xptxas -v prints it
PTXAS_K1 = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111score_pairsENS_4ArgsEib' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111score_pairsENS_4ArgsEib
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_resources_reads_one_kernels_report():
    assert profiling.ptxas_resources(PTXAS_K1) == {
        "registers": 168, "spill_bytes": 0, "static_smem": 0}
    spilled = PTXAS_K1.replace("Used 168 registers,", "Used 255 registers, 41472 bytes smem,")
    spilled = spilled.replace("0 bytes spill stores", "84 bytes spill stores")
    assert profiling.ptxas_resources(spilled) == {
        "registers": 255, "spill_bytes": 84, "static_smem": 41472}
    with pytest.raises(ValueError, match="one kernel"):
        profiling.ptxas_resources(PTXAS_K1 + PTXAS_K1)


def test_ptxas_resources_picks_one_entry_function_of_a_library():
    """fma_probe.cu builds 12 kernels into one library: `kernel` picks one."""
    def report(name, regs):
        return (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{name}EEvNS_4ArgsE' "
                "for 'sm_90a'\nptxas info    : Function properties for x\n    0 bytes stack "
                f"frame, 0 bytes spill stores, 0 bytes spill loads\nptxas info    : Used {regs} "
                "registers, used 0 barriers\n")
    log = (report("13probe_dynloadILi8", 72) + report("13probe_dynloadILi32", 74)
           + report("9probe_fmaILi8", 30))
    assert profiling.ptxas_resources(log, "probe_dynloadILi8E")["registers"] == 72
    assert profiling.ptxas_resources(log, "probe_dynloadILi32E")["registers"] == 74
    with pytest.raises(ValueError, match="one entry function"):
        profiling.ptxas_resources(log, "probe_sload")
    with pytest.raises(ValueError, match="one kernel"):
        profiling.ptxas_resources(log)


@pytest.mark.parametrize("registers, threads, smem, warps", [
    (168, 96, 16896, 12),  # K1 at C = 16: registers bind (4 blocks)
    (128, 96, 16896, 15),  # K1 at C = 8: 5 blocks
    (255, 256, 0, 8),  # PR 1's K1 at C = 16: one block of 8 warps
    (32, 96, 16896, 39),  # shared memory binds: 13 blocks of 17,920 B
    (16, 32, 0, 32),  # the 32-block limit binds
])
def test_resident_warps_on_an_sm90_sm(registers, threads, smem, warps):
    assert profiling.resident_warps(registers, threads, smem) == warps


def _sass(body: str) -> str:
    """A `cuobjdump -sass` listing of one function whose instructions are
    `body`'s lines, 16 bytes apart from 0x0000."""
    lines = [f"        /*{16 * k:04x}*/                   {ins} ;"
             for k, ins in enumerate(body.strip().splitlines())]
    return "\t\tFunction : _ZN12_GLOBAL__N_114score_pairs_v1ILb0EEEvNS_4ArgsE\n" + "\n".join(lines)


# a row loop (0x10 ... 0xc0) around a column-load loop (0x20 ... 0x40): in the
# guarded form each band cell branches round its dot, in the branch-free form a
# select takes +inf
GUARDED = """
MOV R1, c[0x0][0x28]
LDG.E R4, desc[UR4][R2.64]
STS [R5], R4
@P0 BRA 0x20
BAR.SYNC.DEFER_BLOCKING 0x0
@!P1 BRA 0x90
LDS R6, [R7]
FFMA R8, -R6, R9, 1
@!P2 BRA 0xb0
LDS.128 R12, [R7+0x200]
FFMA R10, -R12, R9, 1
@P3 BRA 0x10
EXIT
"""
BRANCH_FREE = """
MOV R1, c[0x0][0x28]
LDG.E R4, desc[UR4][R2.64]
STS [R5], R4
@P0 BRA 0x20
BAR.SYNC.DEFER_BLOCKING 0x0
LDS.128 R6, [R7]
FFMA R8, -R6, R9, 1
LDS.128 R12, [R7+0x200]
FFMA R10, -R12, R9, 1
FSEL R8, R8, +INF , P1
FSEL R10, R10, +INF , P2
@P3 BRA 0x10
EXIT
"""


@pytest.mark.parametrize("body,blocks,branches,lds", [
    (GUARDED, 6, 4, {"LDS": 1, "LDS.128": 1}),
    (BRANCH_FREE, 3, 2, {"LDS.128": 2}),
], ids=["guarded", "branch_free"])
def test_sass_loop_facts_of_a_row_loop(body, blocks, branches, lds):
    """The row loop is the innermost loop that holds the barrier; its basic
    blocks, conditional branches and loads by width, and the instructions
    with the immediate 1, as tests/test_torch_cuda.py reads K5's on the card."""
    (name, insns), = profiling.sass_functions(_sass(body)).items()
    assert "score_pairs_v1" in name
    assert profiling.sass_loops(insns) == [(0x20, 0x30), (0x10, 0xb0)]
    lo, hi = profiling.innermost_loop(insns, ("BAR",))
    assert (lo, hi) == (0x10, 0xb0)
    facts = profiling.loop_facts(insns, lo, hi)
    assert (facts["basic_blocks"], facts["conditional_branches"]) == (blocks, branches)
    assert {k: v for k, v in facts["full_ops"].items() if k.startswith("LDS")} == lds
    assert facts["ops"]["FFMA"] == 2 and facts["insns"] == 11
    assert profiling.immediate_ops(insns, "1") == {"FFMA": 2}
    assert profiling.innermost_loop(insns, ("STS",)) == (0x20, 0x30)
    with pytest.raises(ValueError, match="0 innermost loops holding MUFU"):
        profiling.innermost_loop(insns, ("MUFU",))


@pytest.mark.parametrize("source", ["fused_dtw_v4.cu", "fused_dtw_v3.cu", "fused_dtw_v2.cu",
                                    "fused_dtw_v1.cu", "banded_dtw.cu", "biquad.cu",
                                    "mfcc_front.cu"])
def test_profiled_launches_keys_each_kernel_by_its_wrapper(source):
    """Every `__global__` function of a wrapped kernel's source maps to the
    one launch count its wrapper keeps (`profiled_launches` names a graph's
    replayed kernels by it), and that count exists."""
    from rustpotter_tpu_torch.ops import banded_dtw, biquad, frontend, fused_dtw

    counts = {**fused_dtw.LAUNCHES, **banded_dtw.LAUNCHES, **biquad.LAUNCHES,
              **frontend.LAUNCHES}
    path = os.path.join(os.path.dirname(profiling.__file__), "..", "csrc", source)
    text = open(path).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)
    assert names, source
    for name in names:
        keys = [k for pattern, k in profiling._WRAPPER_OF
                if pattern.search(f"void {name}<16, 5>(Args, int, bool)")]
        assert len(keys) == 1 and keys[0] in counts, (source, name, keys)


def test_profiled_kernels_and_launches_take_the_median_of_the_readings(monkeypatch):
    """Both read the same profiles: per name the median launches per call
    over the readings (a name a reading missed counts 0 there), rounded to
    whole launches; the port's kernels keyed by wrapper, and the total of
    every row."""
    readings = iter([
        [(0.5, 2.0, "void score_pairs<16, 5>(Args, int, bool)"), (0.1, 45.0, "ampere_sgemm"),
         (0.0, 3.0, "Memcpy DtoD (Device -> Device)"), (0.0, 0.2, "vectorized_elementwise")],
        [(0.5, 2.0, "void score_pairs<16, 5>(Args, int, bool)"), (0.1, 44.0, "ampere_sgemm")],
        [(0.5, 1.0, "void score_pairs<16, 5>(Args, int, bool)"), (0.1, 45.0, "ampere_sgemm"),
         (0.0, 2.6, "Memcpy DtoD (Device -> Device)")],
    ] * 2)
    monkeypatch.setattr(profiling, "device_kernels", lambda fn, n: next(readings))
    kernels = profiling.profiled_kernels(None, 5)
    # medians 2, 45, 2.6 (a dropped record) and 0 (read once), rounded
    assert kernels == {"void score_pairs<16, 5>(Args, int, bool)": 2, "ampere_sgemm": 45,
                       "Memcpy DtoD (Device -> Device)": 3}
    assert profiling.profiled_launches(None, 5) == ({"fused_dtw_v4": 2}, 48.6)


@pytest.mark.parametrize("name,copy", [
    ("Memcpy DtoD (Device -> Device)", True), ("memcpy32_post", True),
    ("memcpy64_post", True), ("Memcpy HtoD (Pageable -> Device)", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", False),
    ("memcpy32_postfix_kernel", False)])
def test_is_copy_names_the_device_copies_of_an_eager_call_and_a_replay(name, copy):
    assert profiling.is_copy(name) is copy
    kernels, copies = profiling.split_copies({name: 3.0, "ampere_sgemm": 2.0})
    assert (copies, kernels) == ((3.0, {"ampere_sgemm": 2.0}) if copy
                                 else (0, {name: 3.0, "ampere_sgemm": 2.0}))
