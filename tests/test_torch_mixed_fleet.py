"""The `mixed` deployment of the benchmark (`portbench/configs/mixed.json`:
three recorded DTW wakewords of 8 templates and a LARGE NN wakeword in one
detector, a 168-frame window) run through `BatchedDetector` on the CPU at a
tiny fleet, with tracing on, and held to the benchmark's float64 reference
(`portbench/reference/`) as a run of the cell `mixed.backlog` is.

On the same run: the utterance stream's events merge candidates of both
kinds (the reference fires with the NN wakeword taken out, and with the
three DTW wakewords taken out), and the plain K1's gate counts by wakeword
add up to the fleet's.

Workload: 8 streams (two utterance streams, two near streams, four noise
streams), six 33-chunk `process_sequence` calls, seeded weights.

The cell's `correct` compares the reported candidate's scores, and every
report there is the NN's, so K1's 27 pairs enter it only where `bench`
crosses its threshold. K1 is held here instead, at the cell's shapes: the
`mixed` wakewords' template set and gate bounds as the program builds them
(3 DTW wakewords of 8 templates and their averages, P = 27 pairs of 100-86,
80-66 and 60-46 rows, the averages 100, 80 and 60, padded to Lm = 100;
C = 16, w = 5) in a 168-frame window, the window, new rows and CMN means
drawn from a seed. On the card the kernel at B = 65536 is held to the plain
version on the same card inputs; on the CPU and on the card, the check
fails a K1 that returns +inf for every pair p >= K, and one that scores
wakewords 1 and 2 on float16-rounded operands. Tolerance: K1's own, rtol
3e-6 / atol 2e-4 on similarities (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import detector as refdet
from portbench import wakewords
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.stream_step import chunk_constants
from rustpotter_tpu_torch.utils import tracing

CELL = "mixed.backlog"
SEED = 20261018
TINY = {"streams": 8, "utterance_every": 4, "check_streams": 6, "check_utterance": 2,
        "check_near": 2, "profile_steps": 1, "warmup_steps": 5}


@pytest.fixture(scope="module")
def mixed_run():
    """The run's result, the tracer's counters over it, and the reference's
    report of the fleet's utterance streams by the wakewords kept."""
    tracing.disable()
    tracing.reset()
    tracing.enable()
    try:
        res = harness.run(CELL, SEED, 0.01, False, 0.0, device="cpu", traffic=TINY)
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    c = harness.cell(CELL)
    ww, fleet, _ = harness.inputs(c.config, {**c.traffic, **TINY}, SEED, torch.device("cpu"))
    pcm = fleet.stream_pcm(fleet.utt.tolist(), res["chunks"]).double()
    s = wakewords.settings(c.config)
    kinds = {"all": ww.reference,
             "dtw": [w for w in ww.reference if isinstance(w, refdet.DtwWakeword)],
             "nn": [w for w in ww.reference if isinstance(w, refdet.NnWakeword)]}
    reports = {k: refdet.run_streams(pcm, kept, s, c.config["mfcc_size"], "f64")
               for k, kept in kinds.items()}
    return res, counters, reports


def test_the_mixed_cell_is_correct_against_the_reference(mixed_run):
    res, _, _ = mixed_run
    assert res["checks"]["reference_fires"]["value"] >= 1
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 6 * res["chunks"]


@pytest.mark.parametrize("kept", ["dtw", "nn"])
def test_the_utterance_stream_fires_on_either_kind_alone(mixed_run, kept):
    """The reference fires on each utterance stream with only the DTW
    wakewords, and with only the NN wakeword, as often as with all four."""
    _, _, reports = mixed_run
    alone, both = reports[kept], reports["all"]
    assert alone.fired.any(axis=1).all()
    assert (alone.fired.sum(axis=1) == both.fired.sum(axis=1)).all()


def test_a_report_merges_the_candidates_of_both_kinds(mixed_run):
    """With all four wakewords each report counts the DTW candidates and the
    NN candidates of its utterance, and names the LARGE NN wakeword (index
    3, after the DTW ones), whose score is above the DTW wakeword `bench`'s:
    its candidates came first, and a later candidate of `bench` did not
    replace them."""
    _, _, reports = mixed_run
    both, dtw, nn = reports["all"], reports["dtw"], reports["nn"]
    assert (both.counter[both.fired] == dtw.counter[dtw.fired] + nn.counter[nn.fired]).all()
    assert (both.ww[both.fired] == 3).all() and (dtw.ww[dtw.fired] == 0).all()
    assert (both.score[both.fired] > dtw.score[dtw.fired]).all()


def test_plain_k1_counts_by_wakeword_add_up_to_the_fleets(mixed_run):
    _, counters, _ = mixed_run
    names = [tracing.k1_wakeword_names(d) for d in range(3)]
    assert all(n in counters for pair in names for n in pair)
    assert "k1.lanes_open.w3" not in counters  # the NN wakeword has no K1 pairs
    for i, total in ((0, "k1.lanes_open"), (1, "k1.blocks_run")):
        assert sum(counters[pair[i]] for pair in names) == counters[total] > 0


RTOL, ATOL = 3e-6, 2e-4
FAULTS = ("inf_from_pair_K", "float16_wakewords_1_2")


def _k1_cell(device, B: int, seed: int) -> dict:
    """K1's operands at the cell's shapes on `device`: the program's template
    set and gate bounds for the `mixed` wakewords, and a window, new rows and
    CMN means drawn from `seed` (the window's cursor wraps around)."""
    c = harness.cell(CELL)
    objs, cfg = wakewords.for_program(
        wakewords.build(c.config, torch.Generator().manual_seed(seed), "cpu"), c.config)
    static, params = build_bundle(objs, cfg, device)
    consts = chunk_constants(static, params)
    D, K, F, C = static.n_dtw, static.kmax, static.max_mfcc_frames, static.mfcc_size
    P = len(consts.tset.lens)
    assert (D, K, P, F, C, consts.tset.tp.shape[1]) == (3, 8, 27, 168, 16, 100)
    g = torch.Generator(device=device).manual_seed(seed)
    return dict(win=torch.randn((F, C, B), generator=g, device=device),
                new=torch.randn((3, C, B), generator=g, device=device),
                means3=0.2 * torch.randn((3, P, C, B), generator=g, device=device),
                seq_a=consts.seq_a, tset=consts.tset, bounds=consts.gate_bounds, D=D, K=K,
                rot0=torch.tensor(F - 2, dtype=torch.int32, device=device))


def _k1(x: dict, bounds, half=False, streams=slice(None)):
    """K1 (the kernel on a card, the plain version on the CPU) on x's
    streams; with `half`, on operands rounded to float16."""
    r = (lambda t: t.half().float()) if half else (lambda t: t)
    tset = x["tset"]
    if half:
        tpl = r(x["seq_a"])
        tset = fd.prepare_templates(tpl, torch.sum(tpl * tpl, dim=-1), tset.lens, tset.band)
    pick = lambda t: r(t[..., streams]).contiguous()
    return fd.score_chunk(pick(x["win"]), pick(x["new"]), pick(x["means3"]), tset, bounds,
                          x["D"], x["K"], x["rot0"])


def _assert_k1_close(got, want):
    """(B, 3, P) sims: +inf at the same places, the rest within tolerance."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _faulted(fault: str, got, x: dict, bounds, streams=slice(None)):
    """`got` as a K1 with `fault` would return it on x's streams."""
    D, K = x["D"], x["K"]
    bad = got.clone()
    if fault == "inf_from_pair_K":
        bad[:, :, K:] = float("inf")
    else:
        pairs = [*range(K, D * K), *range(D * K + 1, D * K + D)]
        bad[:, :, pairs] = _k1(x, bounds, half=True, streams=streams)[:, :, pairs]
    return bad


def _gates(x: dict, open_sims) -> dict:
    """The cell's gate bounds, every gate open, and each wakeword's gate at
    the median of its avg similarities (half its lanes open)."""
    D, K = x["D"], x["K"]
    avg = open_sims[:, :, D * K:].reshape(-1, D)
    return {"cell": x["bounds"], "open": torch.full_like(x["bounds"], float("inf")),
            "median": avg.median(dim=0).values.contiguous()}


@pytest.fixture(scope="module")
def k1_cpu():
    """The cell's K1 operands at 64 streams on the CPU, and the plain
    version's sims at each gate setting."""
    x = _k1_cell(torch.device("cpu"), 64, SEED)
    gates = _gates(x, _k1(x, torch.full_like(x["bounds"], float("inf"))))
    return x, {name: (bounds, _k1(x, bounds)) for name, bounds in gates.items()}


@pytest.mark.parametrize("fault", FAULTS)
def test_the_k1_check_fails_a_fault_in_wakewords_1_and_2(k1_cpu, fault):
    """On the CPU at 64 streams: each fault of K1's pairs beyond wakeword 0
    fails the check that holds the kernel to the plain version, at every
    gate setting, where the plain version passes it."""
    x, runs = k1_cpu
    for name, (bounds, want) in runs.items():
        assert np.isfinite(want[:, :, x["K"]:].numpy()).any(), name
        _assert_k1_close(want, want)
        with pytest.raises(AssertionError):
            _assert_k1_close(_faulted(fault, want, x, bounds), want)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["cell", "open", "median"])
def test_k1_at_the_mixed_cell_shapes_matches_the_plain_version_on_card(gate):
    """K1 on the card at the cell's shapes and fleet, B = 65536, against the
    plain version on the same card inputs (in slices of 8192 streams), every
    pair of every wakeword compared where the plain version is finite; the
    check fails each fault on the kernel's own output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU build")
    dev, B, S = torch.device("cuda"), 65536, 8192
    x = _k1_cell(dev, B, SEED)
    open_bounds = torch.full_like(x["bounds"], float("inf"))
    bounds = _gates(x, _k1(x, open_bounds))[gate]
    got = _k1(x, bounds)
    tnorms = torch.sum(x["seq_a"] * x["seq_a"], dim=-1)
    want = torch.cat([fd.fused_dtw_chunk_v4_ref(
        x["win"][..., i:i + S], x["new"][..., i:i + S], x["means3"][..., i:i + S], x["seq_a"],
        tnorms, bounds, x["tset"].lens, x["tset"].band, x["D"], x["K"], x["rot0"])
        for i in range(0, B, S)])
    finite = np.isfinite(want.cpu().numpy()).mean(axis=(0, 1))
    assert (finite > 0).all(), finite  # each of the 27 pairs is compared
    _assert_k1_close(got, want)
    part = slice(0, S)
    for fault in FAULTS:
        with pytest.raises(AssertionError):
            _assert_k1_close(_faulted(fault, got[part], x, bounds, part), want[part])
    gap = (got - want).abs().cpu().numpy()[np.isfinite(want.cpu().numpy())].max()
    print(f"K1 at the mixed cell's shapes, gate {gate}: finite share by pair "
          f"{np.round(finite, 3).tolist()}, widest gap {gap:.3e}")
