"""K1 of the PyTorch port (rustpotter_tpu_torch.ops.fused_dtw) against the JAX
package: its plain version against the scan-path oracle (band_costs +
banded_dtw_batch on the materialized virtual windows) and against the Pallas
kernel in interpret mode, with open, closed and mixed avg gates, at the
unit shapes and at ragged ones (pair lengths 1 and 2, P = 18). The
hand-written kernel is held against the plain version on the card in
tests/test_torch_cuda.py, and its schedule on the CPU in
tests/test_torch_k1_schedule.py.

Tolerance: rtol 3e-6, atol 2e-4 on similarities (sums of up to 40 cosine
costs) — the JAX kernel tests' own (tests/test_dtw_and_scoring.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu.ops.dtw import band_costs as jax_band_costs
from rustpotter_tpu.ops.dtw import banded_dtw_batch as jax_banded_dtw_batch
from rustpotter_tpu.ops.fused_dtw import fused_dtw_chunk_v4 as jax_fused_dtw_chunk_v4
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.ops.dtw import band_costs, banded_dtw_batch

torch.set_num_threads(2)

RTOL, ATOL = 3e-6, 2e-4
D, K = 2, 2
P = D * K + D
B, LM, C, W = 30, 40, 8, 5
LENS = (40, 31, 28, 37) + (35, 40)  # D*K templates, then D avgs


def _inputs(F: int, P=P, Lm=LM, C=C, B=B, seed=None) -> dict:
    rng = np.random.default_rng(6 + F if seed is None else seed)
    templates = rng.normal(0, 1, (P, Lm, C)).astype(np.float32)
    return dict(
        win=rng.normal(0, 1, (F, C, B)).astype(np.float32),  # circular
        new=rng.normal(0, 1, (3, C, B)).astype(np.float32),
        means3=rng.normal(0, 0.2, (3, P, C, B)).astype(np.float32),
        templates=templates,
        tnorms=np.sum(templates ** 2, axis=-1).astype(np.float32),
        rot0=F - 2,  # wrap-around exercised
    )


def _jax_scan_oracle(x: dict, lens=LENS, w=W) -> np.ndarray:
    """Each shift's virtual window materialized, then the JAX scan-path DP."""
    F, C, B = x["win"].shape
    P, LM = x["templates"].shape[:2]
    rot0 = x["rot0"]
    oracle = np.zeros((B, 3, P), np.float32)
    virt = x["win"].copy()
    for s in range(3):
        virt[(rot0 + 1 + s) % F] = x["new"][s]
        rot_s = (rot0 + s + 1) % F
        order = [(rot_s + 1 + i) % F for i in range(LM)]
        lin = np.transpose(virt[order], (2, 0, 1))  # (B, Lm, C)
        normwin = lin[:, None] - np.transpose(x["means3"][s], (2, 0, 1))[:, :, None]
        costs = jax_band_costs(
            jnp.asarray(np.broadcast_to(x["templates"], (B, P, LM, C))).reshape(B * P, LM, C),
            jnp.asarray(normwin).reshape(B * P, LM, C),
            w,
        )
        lens_b = jnp.asarray(np.broadcast_to(np.array(lens, np.int32), (B, P)).reshape(-1))
        oracle[:, s] = np.asarray(jax_banded_dtw_batch(costs, lens_b, w)).reshape(B, P)
    return oracle


def _torch_args(x: dict, gate, device="cpu", lens=LENS, w=W, D=D, K=K):
    t = lambda a: torch.tensor(a, device=device)
    return (
        t(x["win"]), t(x["new"]), t(x["means3"]), t(x["templates"]), t(x["tnorms"]),
        torch.tensor(np.asarray(gate, np.float32), device=device), lens, w, D, K,
        torch.tensor(x["rot0"], dtype=torch.int32, device=device),
    )


@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_plain_version_matches_jax_scan_oracle_and_gates(F):
    x = _inputs(F)
    oracle = _jax_scan_oracle(x)
    got = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, [np.inf, np.inf])).numpy()
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL, err_msg=f"F={F}")

    # ww0 gated out at every shift: its template sims are +inf, the rest exact
    closed = [float(oracle[:, :, D * K].min()) - 1.0, np.inf]
    got = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, closed)).numpy()
    assert np.all(np.isinf(got[:, :, :K]))
    np.testing.assert_allclose(got[:, :, K:], oracle[:, :, K:], rtol=RTOL, atol=ATOL)

    # mixed bound (between the avg sims around the median): template sims
    # are finite exactly where that stream's avg sim passes, and exact there
    v = np.sort(oracle[:, :, D * K].ravel())
    bound = float((v[len(v) // 2 - 1] + v[len(v) // 2]) / 2)
    got = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, [bound, np.inf])).numpy()
    passing = np.repeat((oracle[:, :, D * K] <= bound)[..., None], K, axis=-1)
    assert 0 < passing.sum() < passing.size
    np.testing.assert_array_equal(np.isfinite(got[:, :, :K]), passing)
    np.testing.assert_allclose(got[:, :, :K][passing], oracle[:, :, :K][passing],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, :, K:], oracle[:, :, K:], rtol=RTOL, atol=ATOL)


def test_plain_version_matches_jax_pallas_kernel_interpret():
    x = _inputs(LM + 2)
    want = np.asarray(jax_fused_dtw_chunk_v4(
        jnp.asarray(x["win"]), jnp.asarray(x["new"]), jnp.asarray(x["means3"]),
        jnp.asarray(x["templates"]), jnp.asarray(x["tnorms"]),
        jnp.full((D,), np.inf, jnp.float32), LENS, W, D, K, x["rot0"],
        interpret=True,
    ))
    got = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, [np.inf, np.inf])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# The ragged shapes of the kernel's schedule test and card tests: pair
# lengths 1 (no DP row: +inf) and 2 (the shortest DP) beside Lm, and several
# wakewords (D = 3, K = 5, P = 18, as kernel_parity's K1 check); (D, K, lens)
RAGGED_LM, RAGGED_C, RAGGED_B = 12, 4, 5
RAGGED = {
    "P6": (2, 2, (12, 2, 1, 7) + (12, 9)),
    "P18": (3, 5, (12, 1, 2, 11, 7, 2, 12, 5, 9, 1, 3, 12, 10, 6, 8) + (12, 2, 11)),
}


@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("F", [RAGGED_LM, RAGGED_LM + 2, RAGGED_LM + 9])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_plain_version_matches_jax_scan_oracle_at_ragged_lengths(case, F, w):
    """Gates open, ww0's closed, and ww0's between its avg sims."""
    Dr, Kr, lens = RAGGED[case]
    x = _inputs(F, len(lens), RAGGED_LM, RAGGED_C, RAGGED_B, seed=10 * F + w)
    args = lambda gate: _torch_args(x, gate, lens=lens, w=w, D=Dr, K=Kr)
    oracle = _jax_scan_oracle(x, lens, w)
    assert np.isinf(oracle[:, :, [i for i, n in enumerate(lens) if n == 1]]).all()
    opened = [np.inf] * Dr
    got = fd.fused_dtw_chunk_v4_ref(*args(opened)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle))
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)

    avg0 = oracle[:, :, Dr * Kr]
    closed = [float(avg0.min()) - 1.0] + opened[1:]
    got = fd.fused_dtw_chunk_v4_ref(*args(closed)).numpy()
    assert np.isinf(got[:, :, :Kr]).all()
    np.testing.assert_allclose(got[:, :, Kr:], oracle[:, :, Kr:], rtol=RTOL, atol=ATOL)

    v = np.sort(avg0.ravel())
    mixed = [float((v[len(v) // 2 - 1] + v[len(v) // 2]) / 2)] + opened[1:]
    got = fd.fused_dtw_chunk_v4_ref(*args(mixed)).numpy()
    passing = np.repeat((avg0 <= mixed[0])[..., None], Kr, axis=-1)
    assert 0 < passing.sum() < passing.size
    want = np.where(passing, oracle[:, :, :Kr], np.inf)
    np.testing.assert_array_equal(np.isinf(got[:, :, :Kr]), np.isinf(want))
    np.testing.assert_allclose(got[:, :, :Kr], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, :, Kr:], oracle[:, :, Kr:], rtol=RTOL, atol=ATOL)


def test_plain_version_matches_jax_pallas_kernel_interpret_at_p18():
    Dr, Kr, lens = RAGGED["P18"]
    F, w = RAGGED_LM + 9, 3
    x = _inputs(F, len(lens), RAGGED_LM, RAGGED_C, RAGGED_B, seed=10 * F + w)
    want = np.asarray(jax_fused_dtw_chunk_v4(
        jnp.asarray(x["win"]), jnp.asarray(x["new"]), jnp.asarray(x["means3"]),
        jnp.asarray(x["templates"]), jnp.asarray(x["tnorms"]),
        jnp.full((Dr,), np.inf, jnp.float32), lens, w, Dr, Kr, x["rot0"],
        interpret=True,
    ))
    got = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, [np.inf] * Dr, lens=lens, w=w, D=Dr,
                                                 K=Kr)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version():
    x = _inputs(LM)
    before = fd.LAUNCHES["fused_dtw_v4"]
    got = fd.fused_dtw_chunk_v4(*_torch_args(x, [np.inf, 1.0]))
    want = fd.fused_dtw_chunk_v4_ref(*_torch_args(x, [np.inf, 1.0]))
    assert got.shape == (B, 3, P)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fd.LAUNCHES["fused_dtw_v4"] == before  # the plain path launches nothing


def test_prepared_template_set_is_the_plain_version_on_cpu():
    """score_chunk on a TemplateSet built once (the serving chunk's route)
    gives the wrapper's result and launches nothing on CPU tensors."""
    x = _inputs(LM + 9)
    args = _torch_args(x, [np.inf, 1.0])
    tset = fd.prepare_templates(args[3], args[4], LENS, W)
    assert tset.padded.shape == (P, W + LM + W, C)
    assert torch.all(tset.padded[:, :W] == 0) and torch.all(tset.padded[:, W + LM:] == 0)
    torch.testing.assert_close(tset.padded[:, W:W + LM], tset.tp, rtol=0, atol=0)
    assert tset.lens_t.dtype == torch.int32 and tuple(tset.lens_t.tolist()) == LENS
    before = fd.LAUNCHES["fused_dtw_v4"]
    got = fd.score_chunk(args[0], args[1], args[2], tset, args[5], D, K, args[10])
    torch.testing.assert_close(got, fd.fused_dtw_chunk_v4_ref(*args), rtol=0, atol=0)
    assert fd.LAUNCHES["fused_dtw_v4"] == before
    with pytest.raises(ValueError, match="tnorms"):
        fd.prepare_templates(args[3], args[4][:, :-1], LENS, W)


def test_torch_scan_dp_matches_jax():
    rng = np.random.default_rng(0)
    n, L, c = 37, 60, 8
    lens = rng.integers(20, L + 1, n).astype(np.int32)
    a = rng.normal(0, 1, (n, L, c)).astype(np.float32)
    b = rng.normal(0, 1, (n, L, c)).astype(np.float32)
    want_costs = np.asarray(jax_band_costs(jnp.asarray(a), jnp.asarray(b), W))
    costs = band_costs(torch.tensor(a), torch.tensor(b), W)
    np.testing.assert_allclose(costs.numpy(), want_costs, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax_banded_dtw_batch(jnp.asarray(want_costs), jnp.asarray(lens), W))
    got = banded_dtw_batch(torch.tensor(want_costs), torch.tensor(lens), W).numpy()
    np.testing.assert_array_equal(got, want)


def test_band_below_two_and_bad_shapes_raise():
    x = _inputs(LM)
    args = list(_torch_args(x, [np.inf, np.inf]))
    with pytest.raises(ValueError, match="band_size >= 2"):
        fd.fused_dtw_chunk_v4(*args[:7], 1, *args[8:])
    with pytest.raises(ValueError, match="means3"):
        fd.fused_dtw_chunk_v4(args[0], args[1], args[2][:, :-1], *args[3:])
    with pytest.raises(ValueError, match="pair lengths"):
        fd.fused_dtw_chunk_v4(*args[:6], LENS[:-1], *args[7:])

