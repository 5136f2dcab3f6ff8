"""The port on a CUDA card: K1 (csrc/fused_dtw_v4.cu), K2 (fused_dtw_v3.cu),
K3 (banded_dtw.cu), K4 (fused_dtw_v2.cu), K5 (fused_dtw_v1.cu) and the probe
kernels V1-V6 (fma_probe.cu) against their plain versions, and the batched
detector and the single-stream Rustpotter on the card against the same on
the CPU; `tools/kernel_parity.py`'s seven checks at B = 8192; and what the
builds must hold: no spills in K4's column form, no guard per band cell in
K5's row loop, no memory load in V3's to V6's rep loops but V5's shared
loads of s. Every test here needs a card (and nvcc, which builds the
kernels at first use); without one they skip. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bands: w = 5 throughout, and where a kernel's shared memory grows with the
band, w up to each kernel's stated limit (K3 2, 6, 8, 20 and W_MAX = 75; K1
2, 5, 6, 8, 9, 10 and 20 at C = 8, its rings passing 48 KB from 9, and 8 at C = 16, and at
ragged shapes 2, 5 and 20 with the window's wrap inside a staged tile; K2 2, 5, 6, 8, 9 and
W_MAX = 20 at C = 16, its ring passing 48 KB from 9; K5 2, 5, 6, 8, 9,
19, 20 and 37 at C = 16), with the ValueError past each limit. K4 takes every band: its ring
form 2, 5, 6, 8, 9 and W_MAX = 19 at C = 16 (its rings pass 48 KB from 8),
its column form 20, 21 and 24, and, with pairs long enough to reuse every
ring slot, 21, 36, 37 (16 streams a block), 44, 52, 60, 68 (each first
band of fewer rows per step) and 75 at C = 16 and 91 at C = 8 (its last
bands), its row form 76 at C = 16 and 92 at C = 8.

Tolerances: sims rtol 3e-6 / atol 2e-4 for K1 and K2, atol 1e-4 for K4 and
K5 (the JAX kernel tests' own); K3 is adds and mins only, so bit-exact; the
probes rtol 1e-6 at reps 16 (V5 and V6 fuse a product the plain version
rounds; V5 at every reps tested at fma_probe.PROBE_RTOL), V3
bit-exact at reps 13, 16 and 2000 and V4 at reps 13, 16, 32, 45, 100 and 2000
(their steps add exact halves in the plain version's order); V6 bit-equal
to V5 at reps 13, 16, 31, 33, 64 and 2000 (the same operations in the same
order),
K5 held to K4 at w = 5 and 9 at rtol 3e-6 / atol 1e-4, most sims bit-equal
(K4's compiled code rounds one band slot's cost product, K5 fuses every
one); event scores
rtol 2e-5 / atol 2e-5 (the CPU slice test's).
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import Rustpotter, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.ops.dtw import banded_dtw_batch
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream
from rustpotter_tpu_torch.tools import fma_probe, kernel_parity
from rustpotter_tpu_torch.utils import tracing
from rustpotter_tpu_torch.utils.profiling import (
    innermost_loop,
    loop_facts,
    ptxas_resources,
    sass_functions,
    sass_listing,
)

RTOL, ATOL, ATOL_V2 = 3e-6, 2e-4, 1e-4
D, K = 2, 2
P = D * K + D
B, LM, C, W = 30, 40, 8, 5
LENS = (40, 31, 28, 37) + (35, 40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


def _args(F: int, device, gate=(np.inf, np.inf), c=C):
    rng = np.random.default_rng(6 + F)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    templates = rng.normal(0, 1, (P, LM, c))
    return (
        t(rng.normal(0, 1, (F, c, B))), t(rng.normal(0, 1, (3, c, B))),
        t(rng.normal(0, 0.2, (3, P, c, B))), t(templates),
        t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), t(gate), LENS, W, D, K,
        torch.tensor(F - 2, dtype=torch.int32, device=device),
    )


def _assert_sims_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_kernel_matches_plain_version_on_card(cuda_device, F):
    args = _args(F, cuda_device)
    avg = fd.fused_dtw_chunk_v4_ref(*args)[:, :, D * K].flatten().sort().values
    mid = float((avg[avg.numel() // 2 - 1] + avg[avg.numel() // 2]) / 2)
    for gate in ((np.inf, np.inf), (float(avg[0]) - 1.0, np.inf), (mid, np.inf)):
        args = _args(F, cuda_device, gate)
        before = fd.LAUNCHES["fused_dtw_v4"]
        got = fd.fused_dtw_chunk_v4(*args)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v4"] == before + 1
        _assert_sims_close(got, fd.fused_dtw_chunk_v4_ref(*args))


# K1 at ragged shapes: three wakewords of five templates (P = 18), pair
# lengths 1 and 2 among them (an avg pair of length 1 is +inf: its gate
# opens only at an infinite bound), n + w odd and even, B not a multiple of
# 32, and gates that close every lane of a block
D3, K5 = 3, 5
LENS18 = (40, 1, 2, 37, 33) + (40, 39, 5, 2, 20) + (1, 12, 40, 3, 38) + (40, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("cursor", ["start", "tile"])
@pytest.mark.parametrize("w", [2, 5, 20])
@pytest.mark.parametrize("nb", [1, 33, 36])
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_k1_ragged_shapes_match_plain_version_on_card(cuda_device, F, nb, w, cursor):
    """Sims as the plain version's, and the gated launch's counters as
    `k1_gate_counts` of the plain version's gate decisions. B = 36 takes
    the 16-byte copies with a last block of 4 streams, 1 and 33 the 4-byte
    ones. The cursor puts
    the circular window's wrap before E's column 0 ("start") or between
    columns 4 and 5, inside the tile that K1 stages for its third step
    ("tile")."""
    rng = np.random.default_rng(100 + F + nb)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    p = len(LENS18)
    templates = rng.normal(0, 1, (p, LM, C))
    x = (t(rng.normal(0, 1, (F, C, nb))), t(rng.normal(0, 1, (3, C, nb))),
         t(rng.normal(0, 0.2, (3, p, C, nb))), t(templates),
         t(np.sum(templates.astype(np.float32) ** 2, axis=-1)))
    rot0 = torch.tensor(F - 2 if cursor == "start" else F - 7, dtype=torch.int32,
                        device=cuda_device)
    args = lambda gate: (*x, t(gate), LENS18, w, D3, K5, rot0)
    avg = fd.fused_dtw_chunk_v4_ref(*args((np.inf,) * D3))[:, :, D3 * K5:].cpu()
    v = avg[..., 0].flatten().sort().values
    mid = float((v[v.numel() // 2 - 1] + v[v.numel() // 2]) / 2)
    closed = [float(avg[..., d].min()) - 1.0 if d < 2 else -1.0 for d in range(D3)]
    for gate in ((np.inf,) * D3, closed, (mid, closed[1], np.inf)):
        want = fd.fused_dtw_chunk_v4_ref(*args(gate))
        before = fd.LAUNCHES["fused_dtw_v4"]
        tracing.reset()
        tracing.enable()
        try:
            got = fd.fused_dtw_chunk_v4(*args(gate))
            counts = tracing.snapshot()["counters"]
        finally:
            tracing.disable()
            tracing.reset()
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v4"] == before + 1
        _assert_sims_close(got, want)
        gate_open = (want[:, :, D3 * K5:].cpu() <= torch.tensor(gate, dtype=torch.float32))
        gate_open = gate_open.repeat_interleave(K5, dim=2).permute(1, 2, 0)
        assert [counts[k] for k in tracing.DEVICE_COUNTERS] == list(
            fd.k1_gate_counts(gate_open, LENS18[:D3 * K5]))


@pytest.mark.cuda
def test_batched_detector_on_card_matches_cpu(cuda_device):
    ww, utterance = build_bench_wakeword(device=cuda_device)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    n = 4
    stream0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(5).normal(0, 0.05, (len(stream0), n, 480)).astype(np.float32)
    frames[:, 0] = stream0
    runs = []
    for dev in (cuda_device, "cpu"):
        det = BatchedDetector([("w", ww)], cfg, batch_size=n, device=dev)
        before = fd.LAUNCHES["fused_dtw_v4"]
        _, ev = det.process_sequence(det.params, det.init_states(), frames)
        runs.append((events_to_numpy(ev), fd.LAUNCHES["fused_dtw_v4"] - before))
    (gpu, launches), (cpu, cpu_launches) = runs
    assert (launches, cpu_launches) == (len(frames), 0)
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    fired = cpu.fired
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[fired], getattr(cpu, f)[fired],
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    fired0 = int(cpu.fired[:, 0].sum())
    assert fired0 >= 1


def _v3_args(F: int, nb: int, device, gate=(np.inf, np.inf)):
    rng = np.random.default_rng(16 + F + nb)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    templates = rng.normal(0, 1, (P, LM, C))
    return (
        t(rng.normal(0, 1, (F, C, nb))), t(rng.normal(0, 0.2, (P, C, nb))), t(templates),
        t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), t(gate), LENS, W, D, K,
        torch.tensor(F - 2, dtype=torch.int32, device=device),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("F,nb", [(LM, 1), (LM + 2, 33), (LM + 9, B)])
def test_k2_matches_plain_version_on_card(cuda_device, F, nb):
    args = _v3_args(F, nb, cuda_device)
    avg = fd.fused_dtw_batch_v3_ref(*args)[:, D * K].sort().values
    # one stream: a bound well above its avg, so that the gate passes
    mid = float((avg[nb // 2 - 1] + avg[nb // 2]) / 2) if nb > 1 else float(avg[0]) + 1.0
    for gate in ((np.inf, np.inf), (float(avg[0]) - 1.0, np.inf), (mid, np.inf)):
        args = _v3_args(F, nb, cuda_device, gate)
        before = fd.LAUNCHES["fused_dtw_v3"]
        got = fd.fused_dtw_batch_v3_t(*args)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v3"] == before + 1
        _assert_sims_close(got, fd.fused_dtw_batch_v3_ref(*args))


K2_W_MAX = 20  # the largest band whose cost ring fits the opt-in (csrc/fused_dtw_v3.cu)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 5, 6, 8, 9, K2_W_MAX])  # the ring passes 48 KB from 9
def test_k2_bands_at_c16_match_plain_version_on_card(cuda_device, w):
    """K2 at the bench C = 16 over 50 streams (a partial second block), the
    gate open, closed and mixed, at every band up to its limit."""
    rng = np.random.default_rng(60 + w)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    c, nb, F = 16, 50, LM + 9
    templates = rng.normal(0, 1, (P, LM, c))
    x = (t(rng.normal(0, 1, (F, c, nb))), t(rng.normal(0, 0.2, (P, c, nb))), t(templates),
         t(np.sum(templates.astype(np.float32) ** 2, axis=-1)))
    rot = torch.tensor(F - 2, dtype=torch.int32, device=cuda_device)  # wraps around
    args = lambda gate: (*x, t(gate), LENS, w, D, K, rot)
    avg = fd.fused_dtw_batch_v3_ref(*args((np.inf, np.inf)))[:, D * K].sort().values
    mid = float((avg[nb // 2 - 1] + avg[nb // 2]) / 2)
    for gate in ((np.inf, np.inf), (float(avg[0]) - 1.0, np.inf), (mid, np.inf)):
        before = fd.LAUNCHES["fused_dtw_v3"]
        got = fd.fused_dtw_batch_v3_t(*args(gate))
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v3"] == before + 1
        _assert_sims_close(got, fd.fused_dtw_batch_v3_ref(*args(gate)))


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 33, 50])
def test_k4_matches_plain_version_on_card(cuda_device, nb):
    rng = np.random.default_rng(3 + nb)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    templates = rng.normal(0, 1, (P, LM, C))
    args = (t(rng.normal(0, 1, (nb, LM, C))), t(rng.normal(0, 0.2, (nb, P, C))), t(templates),
            t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), LENS, W)
    before = fd.LAUNCHES["fused_dtw_v2"]
    got = fd.fused_dtw_batch(*args)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v2"] == before + 1
    want = fd.fused_dtw_batch_ref(*args).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL_V2)


# K4 at C = 16: pairs of length 1 and 2, and pairs long enough that the ring
# form reuses a ring row at every place in a round up to its W_MAX
K4_LM = 80
K4_LENS = (K4_LM, 2, 1, 71, 36, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 33, 50])
@pytest.mark.parametrize("w", [2, 5, 6, 8, 9, fd.K4_W_MAX, 20, 21, 24])
def test_k4_bands_at_c16_match_plain_version_on_card(cuda_device, w, nb):
    """K4 on both sides of its change of form (the ring form up to W_MAX =
    19, whose rings pass 48 KB from 8; the column form beyond)."""
    rng = np.random.default_rng(70 + w + nb)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    c, p = 16, len(K4_LENS)
    templates = rng.normal(0, 1, (p, K4_LM, c))
    args = (t(rng.normal(0, 1, (nb, K4_LM, c))), t(rng.normal(0, 0.2, (nb, p, c))),
            t(templates), t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), K4_LENS, w)
    before = fd.LAUNCHES["fused_dtw_v2"]
    got = fd.fused_dtw_batch(*args)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v2"] == before + 1
    want = fd.fused_dtw_batch_ref(*args)
    np.testing.assert_array_equal(np.isinf(got.cpu().numpy()), np.isinf(want.cpu().numpy()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL_V2)


# K4's column form and the row form past it: pairs of length 1 and 2, and
# pairs long enough that a ring slot is reused at every place of a step
K4_COL_LM = 200
K4_COL_LENS = (K4_COL_LM, 2, 1, K4_COL_LM - 1, K4_COL_LM // 2, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("c,w", [(16, 21), (16, 36), (16, 37), (16, 44), (16, 52), (16, 60),
                                 (16, 68), (16, 75), (16, 76), (8, 91), (8, 92)])
def test_k4_wide_bands_match_plain_version_on_card(cuda_device, c, w):
    """K4 past its ring form: the column form at each change of rows per
    step or streams per block and at its last band, the row form beyond, on
    33 streams (a short last block) and on 11 pairs (a second block row)."""
    assert fd.k4_form(w, c) == ("row" if w in (76, 92) else "column")
    rng = np.random.default_rng(90 + w + c)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    for nb, lm, lens in ((33, K4_COL_LM, K4_COL_LENS),
                         (33, 60, tuple(60 - 5 * i for i in range(11)))):
        p = len(lens)
        templates = rng.normal(0, 1, (p, lm, c))
        args = (t(rng.normal(0, 1, (nb, lm, c))), t(rng.normal(0, 0.2, (nb, p, c))),
                t(templates), t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), lens, w)
        before = fd.LAUNCHES["fused_dtw_v2"]
        got = fd.fused_dtw_batch(*args)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v2"] == before + 1
        want = fd.fused_dtw_batch_ref(*args)
        np.testing.assert_array_equal(np.isinf(got.cpu().numpy()), np.isinf(want.cpu().numpy()))
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL,
                                   atol=ATOL_V2)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,lens", [(1, LENS), (33, LENS), (50, LENS),
                                     (33, tuple(40 - 2 * (i % 5) for i in range(11)))])
def test_k5_matches_plain_version_on_card(cuda_device, nb, lens):
    """K5 on 1, 33 and 50 streams, and on 11 pairs (a second block row)."""
    rng = np.random.default_rng(13 + nb + len(lens))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    p = len(lens)
    templates = rng.normal(0, 1, (p, LM, C))
    args = (t(rng.normal(0, 1, (nb, LM, C))), t(rng.normal(0, 0.2, (nb, p, C))), t(templates),
            t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), lens, W)
    before = fd.LAUNCHES["fused_dtw_v1"]
    got = fd.fused_dtw_batch(*args, variant=1)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v1"] == before + 1
    want = fd.fused_dtw_batch_ref(*args).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL_V2)


# K5 at C = 16: pairs of length 1 and 2, and pairs long enough that every
# ring slot is reused at every place of a step at every tested band
K5_LM = 136
K5_LENS = (K5_LM, 2, 1, 135, 50, 9)


def _k5_args(nb, lens, w, seed, device, c=16):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    p = len(lens)
    templates = rng.normal(0, 1, (p, K5_LM, c))
    return (t(rng.normal(0, 1, (nb, K5_LM, c))), t(rng.normal(0, 0.2, (nb, p, c))),
            t(templates), t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), lens, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,lens", [(1, K5_LENS), (33, K5_LENS), (50, K5_LENS),
                                     (33, tuple(K5_LM - 7 * i for i in range(11)))])
@pytest.mark.parametrize("w", [2, 5, 9, 19, 20, 37])
def test_k5_bands_at_c16_match_plain_version_on_card(cuda_device, w, nb, lens):
    """K5 at C = 16 in each of its rows per step (3 at w = 2, 5, 19, 20, 2 at
    9, 1 at 37; its rings pass 48 KB from w = 7), on 1, 33 and 50 streams and
    on 11 pairs (a second block row)."""
    args = _k5_args(nb, lens, w, 100 + w + nb + len(lens), cuda_device)
    before = fd.LAUNCHES["fused_dtw_v1"]
    got = fd.fused_dtw_batch(*args, variant=1)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v1"] == before + 1
    want = fd.fused_dtw_batch_ref(*args)
    np.testing.assert_array_equal(np.isinf(got.cpu().numpy()), np.isinf(want.cpu().numpy()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL_V2)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 6])
def test_k5_scalar_ring_matches_plain_version_on_card(cuda_device, c):
    """C not a multiple of 4 (an mfcc_size of 5 or 6): K5's ring takes one
    value per load, [slot][C][32], in place of the chunk-major LDS.128 form."""
    args = _k5_args(33, K5_LENS, 5, 300 + c, cuda_device, c)
    got = fd.fused_dtw_batch(*args, variant=1)
    want = fd.fused_dtw_batch_ref(*args)
    np.testing.assert_array_equal(np.isinf(got.cpu().numpy()), np.isinf(want.cpu().numpy()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL_V2)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [33, 8192])
@pytest.mark.parametrize("w", [5, 9])
def test_k5_matches_k4_on_card(cuda_device, w, nb):
    """K5 and K4 take each dot, dotm and rwn (rsqrtf) in the same order and
    the same DP, but not quite the same cost: K5 fuses 1 - (dot - dotm) rwn
    into one FMA in every band slot, while K4's compiled code (its SASS:
    2w - 1 FFMAs and one FADD with the immediate 1) rounds the product of
    one slot, 2w - 1, before the sum. So most sims are the same bits and
    the rest differ by an ulp or two: held at rtol 3e-6 / atol 1e-4 (the
    JAX kernels' test of the two), with at least 95 % bit-equal."""
    args = _k5_args(nb, K5_LENS, w, 200 + w, cuda_device)
    k5 = fd.fused_dtw_batch(*args, variant=1).cpu().numpy()
    k4 = fd.fused_dtw_batch(*args, variant=2).cpu().numpy()
    np.testing.assert_array_equal(np.isinf(k5), np.isinf(k4))
    np.testing.assert_allclose(k5, k4, rtol=RTOL, atol=ATOL_V2)
    assert np.mean(k5 == k4) >= 0.95


@pytest.mark.cuda
# every probe at reps 16, and each run that fma_probe times at reps 2000
@pytest.mark.parametrize("name,streams,reps",
                         [(name, S, 16) for name in fma_probe.KERNELS for S in (8, 32)]
                         + [(name, S, fma_probe.REPS) for _, name, S in fma_probe.RUNS])
def test_probe_kernel_matches_plain_version_on_card(cuda_device, name, streams, reps):
    """V1-V4 add exact halves in the plain version's order: bit-exact. V5
    and V6 fuse a product that the plain version rounds first:
    fma_probe.PROBE_RTOL."""
    x, s = fma_probe.inputs(cuda_device)
    before = fma_probe.LAUNCHES[name]
    got = fma_probe.probe(name, x, s, reps, streams, tiles=132)
    torch.cuda.synchronize()
    assert fma_probe.LAUNCHES[name] == before + 1
    want = fma_probe.plain(name, x, s, reps, streams)
    rtol = fma_probe.PROBE_RTOL[reps, streams] if name in ("sload", "smemload") else 0.0
    torch.testing.assert_close(got, want.expand_as(got), rtol=rtol, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [8, 32])
@pytest.mark.parametrize("name", ["dynload", "dynload_cheap", "sload", "smemload"])
def test_v3_to_v6_rep_loops_load_nothing_but_v5s_shared_rows(cuda_device, name, streams):
    """The SASS rep loops of V3, V4 and V6 hold no LDG, LDL, LDS or LDC (x in
    registers, V6's s in the constant bank as operands); V5's no LDG, LDL
    or LDC, and each of its shared loads of s feeds
    `fma_probe.sload_ffma_per_load(S)` FFMAs."""
    ops = fma_probe.rep_loop_facts(fma_probe.sass_listing())[name, streams]["ops"]
    banned = ("LDG", "LDL", "LDC") + (() if name == "sload" else ("LDS",))
    assert not any(ops[op] for op in banned), dict(ops)
    if name == "sload":
        assert ops["LDS"] and ops["FFMA"] == fma_probe.sload_ffma_per_load(streams) * ops["LDS"], (
            dict(ops))


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [13, 16, 2000])  # 13: not a whole number of V3's periods
@pytest.mark.parametrize("streams", [8, 32])
def test_v3_is_bit_exact_against_plain_version_on_card(cuda_device, streams, reps):
    x, s = fma_probe.inputs(cuda_device)
    before = fma_probe.LAUNCHES["dynload"]
    got = fma_probe.probe("dynload", x, s, reps, streams, tiles=132)
    torch.cuda.synchronize()
    assert fma_probe.LAUNCHES["dynload"] == before + 1
    want = fma_probe.plain("dynload", x, s, reps, streams)
    np.testing.assert_array_equal(got.cpu().numpy(), want.expand(132, 8, 128).cpu().numpy())


@pytest.mark.cuda
# V4's loop takes 64 reps: 13-45 run its straight-line remainder alone, 100 and
# 2000 both
@pytest.mark.parametrize("reps", [13, 16, 32, 45, 100, 2000])
@pytest.mark.parametrize("streams", [8, 32])
def test_v4_is_bit_exact_against_plain_version_on_card(cuda_device, streams, reps):
    x, s = fma_probe.inputs(cuda_device)
    before = fma_probe.LAUNCHES["dynload_cheap"]
    got = fma_probe.probe("dynload_cheap", x, s, reps, streams, tiles=132)
    torch.cuda.synchronize()
    assert fma_probe.LAUNCHES["dynload_cheap"] == before + 1
    want = fma_probe.plain("dynload_cheap", x, s, reps, streams)
    np.testing.assert_array_equal(got.cpu().numpy(), want.expand(132, 8, 128).cpu().numpy())


@pytest.mark.cuda
# V5 takes one warp per tile, so any tile count is whole blocks: 1 and 133
# (not a multiple of the 132 SMs); its rep loop has no remainder, and reps
# covers a part of the 32-rep period of r & 31, one period, one and a part,
# and many
@pytest.mark.parametrize("tiles", [1, 133])
@pytest.mark.parametrize("reps", [13, 16, 31, 33, 2000])
@pytest.mark.parametrize("streams", [8, 32])
def test_v5_matches_plain_version_on_card(cuda_device, streams, reps, tiles):
    x, s = fma_probe.inputs(cuda_device)
    before = fma_probe.LAUNCHES["sload"]
    got = fma_probe.probe("sload", x, s, reps, streams, tiles=tiles)
    torch.cuda.synchronize()
    assert fma_probe.LAUNCHES["sload"] == before + 1
    assert got.shape == (tiles, 8, 128)
    want = fma_probe.plain("sload", x, s, reps, streams)
    torch.testing.assert_close(got, want.expand_as(got),
                               rtol=fma_probe.PROBE_RTOL[reps, streams], atol=0)


@pytest.mark.cuda
# V6's loop takes 32 reps: 13, 16 and 31 run its straight-line remainder
# alone, 64 the loop alone (two passes), 33 and 2000 both
@pytest.mark.parametrize("reps", [13, 16, 31, 33, 64, 2000])
@pytest.mark.parametrize("streams", [8, 32])
def test_v6_is_bit_equal_to_v5_on_card(cuda_device, streams, reps):
    """V6 (s in the constant bank) takes V5's steps (s from shared memory)
    in V5's order: the same fmaf sequence, so the same bits."""
    x, s = fma_probe.inputs(cuda_device)
    before = fma_probe.LAUNCHES["smemload"]
    got = fma_probe.probe("smemload", x, s, reps, streams, tiles=132)
    want = fma_probe.probe("sload", x, s, reps, streams, tiles=132)
    torch.cuda.synchronize()
    assert fma_probe.LAUNCHES["smemload"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(1, 60), (33, 60), (300, 60), (1, 2)])  # L = 2 < w
def test_k3_is_bit_exact_against_plain_version_on_card(cuda_device, n, L):
    rng = np.random.default_rng(n)
    costs = torch.tensor(rng.uniform(0, 2, (n, L, 2 * W)).astype(np.float32), device=cuda_device)
    lens = torch.tensor(rng.integers(1, L + 1, n).astype(np.int32), device=cuda_device)
    before = bd.LAUNCHES["banded_dtw"]
    got = bd.banded_dtw_kernel(costs, lens, W)
    torch.cuda.synchronize()
    assert bd.LAUNCHES["banded_dtw"] == before + 1
    want = banded_dtw_batch(costs, lens, W)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# Bands past w = 5 (K3's old static tile held only w <= 5, K5's rings at C =
# 16 only w <= 7): every kernel builds and matches its plain version there,
# and beyond its shared-memory limit its wrapper raises ValueError.

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 300])
@pytest.mark.parametrize("L", [59, 60])  # L*w odd at (59, 5) and (59, 75)
@pytest.mark.parametrize("w", [2, 5, 6, 8, 20, bd.W_MAX])
def test_k3_bands_are_bit_exact_on_card(cuda_device, w, L, n):
    rng = np.random.default_rng(1000 * w + 10 * L + n)
    costs = torch.tensor(rng.uniform(0, 2, (n, L, 2 * w)).astype(np.float32), device=cuda_device)
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[: min(n, 3)] = (L, 2, 1)[: min(n, 3)]
    lens = torch.tensor(lens, device=cuda_device)
    before = bd.LAUNCHES["banded_dtw"]
    got = bd.banded_dtw_kernel(costs, lens, w)
    torch.cuda.synchronize()
    assert bd.LAUNCHES["banded_dtw"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), banded_dtw_batch(costs, lens, w).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [6, 8, 37])  # static rings at 6, opt-in above 48 KB at 8
def test_k5_wide_bands_at_c16_match_plain_version_on_card(cuda_device, w):
    rng = np.random.default_rng(40 + w)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    c, nb = 16, 50
    templates = rng.normal(0, 1, (P, LM, c))
    args = (t(rng.normal(0, 1, (nb, LM, c))), t(rng.normal(0, 0.2, (nb, P, c))), t(templates),
            t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), LENS, w)
    before = fd.LAUNCHES["fused_dtw_v1"]
    got = fd.fused_dtw_batch(*args, variant=1)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v1"] == before + 1
    want = fd.fused_dtw_batch_ref(*args).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL_V2)


@pytest.mark.cuda
# the rings pass 48 KB from w = 9 at C = 8; at C = 16, w = 8 passes w = 5's
# ring 2.2 times
@pytest.mark.parametrize("c,w", [(C, w) for w in (2, 5, 6, 8, 9, 10, 20)] + [(16, 8)])
def test_k1_wide_bands_match_plain_version_on_card(cuda_device, c, w):
    args = list(_args(LM + 2, cuda_device, c=c))
    args[7] = w
    before = fd.LAUNCHES["fused_dtw_v4"]
    got = fd.fused_dtw_chunk_v4(*args)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["fused_dtw_v4"] == before + 1
    _assert_sims_close(got, fd.fused_dtw_chunk_v4_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [21, 24, 37, 75])
def test_k4_column_form_builds_do_not_spill(cuda_device, w):
    """ptxas's report of K4's column-form builds at C = 16: 32 streams a
    block at 21 and 24, 16 at 37, one row a step at 75."""
    from rustpotter_tpu_torch import _build

    assert fd.k4_form(w, 16) == "column"
    defines = {"RP_C": 16, "RP_W": w}
    _build.build("fused_dtw_v2.cu", defines)
    log = _build.build_log("fused_dtw_v2.cu", defines)
    assert ptxas_resources(log)["spill_bytes"] == 0, log


@pytest.mark.cuda
@pytest.mark.parametrize("c,w", [(8, 5), (16, 5), (16, 8), (16, 37)])
def test_k5_row_loop_holds_no_guard_per_band_cell(cuda_device, c, w):
    """K5's cells are branch-free: its SASS row loop (the innermost loop
    with a barrier) holds fewer conditional branches than the 2w band cells
    of each of its rows per step; a guard per cell would add one each."""
    from rustpotter_tpu_torch import _build

    lib = _build.build("fused_dtw_v1.cu", {"RP_C": c, "RP_W": w})
    insns = next(i for f, i in sass_functions(sass_listing(lib, _build.nvcc())).items()
                 if "score_pairs_v1" in f)
    loop = loop_facts(insns, *innermost_loop(insns, ("BAR",)))
    assert loop["conditional_branches"] < 2 * w * fd.k5_rows_per_step(w, c), loop


@pytest.mark.cuda
def test_kernel_parity_at_the_bench_streams_on_card(cuda_device):
    """`tools/kernel_parity.py` at B = 8192: K3 bit-exact against the DP,
    K4 and K2 against its own oracle, K2's gate, K1's whole chunk at P = 6,
    11 and 18 against the oracle on each shift's virtual window."""
    assert len(kernel_parity.run(8192, cuda_device)) == len(kernel_parity.CHECKS)


@pytest.mark.cuda
def test_bands_beyond_the_shared_memory_limits_raise_on_card(cuda_device):
    args = list(_args(LM, cuda_device))
    args[7] = 21  # K1's ring passes the opt-in beyond w = 20
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_dtw_chunk_v4(*args)
    w = bd.W_MAX + 1
    costs = torch.zeros((3, 8, 2 * w), device=cuda_device)
    with pytest.raises(ValueError, match="band_size"):
        bd.banded_dtw_kernel(costs, torch.full((3,), 8, device=cuda_device), w)
    # K3 copies 8-byte units: costs starting 4 bytes into an allocation
    shifted = torch.zeros(3 * 8 * 2 * W + 1, device=cuda_device)[1:].view(3, 8, 2 * W)
    with pytest.raises(ValueError, match="8-byte aligned"):
        bd.banded_dtw_kernel(shifted, torch.full((3,), 8, device=cuda_device), W)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    c = 16
    args = (t(np.zeros((2, LM, c))), t(np.zeros((2, P, c))), t(np.ones((P, LM, c))),
            t(np.full((P, LM), c)), LENS, 38)  # K5's rings at C = 16 pass it beyond w = 37
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_dtw_batch(*args, variant=1)
    args = list(_v3_args(LM, 2, cuda_device))
    args[6] = K2_W_MAX + 1  # K2's cost ring passes the opt-in beyond w = 20
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_dtw_batch_v3_t(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v3", "v2", "unfused"])
def test_rustpotter_on_card_matches_cpu(cuda_device, mode, monkeypatch):
    """The single-stream API on the card launches its mode's kernel 3 times
    per frame and gives the CPU run's detections."""
    if mode == "v2":
        monkeypatch.setenv("RUSTPOTTER_FUSED_VARIANT", "2")
    if mode == "unfused":
        monkeypatch.setenv("RUSTPOTTER_FUSED", "0")
    counts = {"v3": (fd.LAUNCHES, "fused_dtw_v3"), "v2": (fd.LAUNCHES, "fused_dtw_v2"),
              "unfused": (bd.LAUNCHES, "banded_dtw")}[mode]
    ww, utterance = build_bench_wakeword(device=cuda_device)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    frames = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    runs = []
    for dev in (cuda_device, "cpu"):
        rp = Rustpotter(cfg, device=dev)
        rp.add_wakeword_ref("w", ww)
        before = counts[0][counts[1]]
        dets = [(i, d) for i, d in enumerate(map(rp.process_samples, frames)) if d is not None]
        runs.append((dets, counts[0][counts[1]] - before))
    (gpu, launches), (cpu, cpu_launches) = runs
    assert (launches, cpu_launches) == (3 * len(frames), 0)
    assert len(cpu) >= 1 and [i for i, _ in gpu] == [i for i, _ in cpu]
    for (_, g), (_, c) in zip(gpu, cpu):
        assert (g.name, g.counter, g.gain) == (c.name, c.counter, c.gain)
        np.testing.assert_allclose([g.score, g.avg_score, *g.scores.values()],
                                   [c.score, c.avg_score, *c.scores.values()],
                                   rtol=2e-5, atol=2e-5)
