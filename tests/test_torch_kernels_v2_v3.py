"""K2, K3 and K4 of the PyTorch port against the JAX package on the CPU: each
plain version against the JAX Pallas kernel in interpret mode (and K2 also
against the scan-path oracle on the linearized window), plus the wrappers'
CPU dispatch. The hand-written kernels are held against the plain versions
on the card in tests/test_torch_cuda.py.

Tolerances: K2 rtol 3e-6 / atol 2e-4 and K4 rtol 3e-6 / atol 1e-4 on
similarities (sums of up to 60 cosine costs; the JAX kernel tests' own,
tests/test_dtw_and_scoring.py). K2 decides its avg gate per stream where the
TPU decided per (8, 128) tile, so its template sims are compared where the
stream's gate passes. K3 is adds and mins only: bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu.ops.dtw import band_costs as jax_band_costs
from rustpotter_tpu.ops.dtw import banded_dtw_batch as jax_banded_dtw_batch
from rustpotter_tpu.ops.fused_dtw import fused_dtw_batch as jax_fused_dtw_batch
from rustpotter_tpu.ops.fused_dtw import fused_dtw_batch_v3_t as jax_fused_dtw_batch_v3_t
from rustpotter_tpu.ops.pallas_dtw import banded_dtw_pallas
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.ops.dtw import band_costs, banded_dtw_batch
from rustpotter_tpu_torch.ops.dtw_dispatch import get_banded_dtw

torch.set_num_threads(2)

RTOL, ATOL_V3, ATOL_V2 = 3e-6, 2e-4, 1e-4
W = 5
# K2: the shapes of tests/test_dtw_and_scoring.py::test_fused_v3_matches_oracle_and_gates
D, K = 2, 3
P = D * K + D
B, LM, C = 40, 40, 8
LENS = (40, 31, 28, 37, 40, 33) + (35, 40)  # D*K templates, then D avgs
t = torch.tensor


def _v3_inputs(F: int) -> dict:
    rng = np.random.default_rng(4 + F)
    templates = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    return dict(
        win=rng.normal(0, 1, (F, C, B)).astype(np.float32),  # circular
        means=rng.normal(0, 0.2, (P, C, B)).astype(np.float32),
        templates=templates,
        tnorms=np.sum(templates ** 2, axis=-1).astype(np.float32),
        rot=F - 2,  # wrap-around exercised
    )


def _v3_args(x: dict, gate):
    return (t(x["win"]), t(x["means"]), t(x["templates"]), t(x["tnorms"]),
            t(np.asarray(gate, np.float32)), LENS, W, D, K,
            t(x["rot"], dtype=torch.int32))


def _scan_oracle(lin: np.ndarray, means: np.ndarray, templates, lens) -> np.ndarray:
    """JAX scan path on linear windows lin (B, Lm, C), means (B, P, C)."""
    b, lm, c = lin.shape
    p = means.shape[1]
    normwin = lin[:, None] - means[:, :, None]
    costs = jax_band_costs(
        jnp.asarray(np.broadcast_to(templates, (b, p, lm, c))).reshape(b * p, lm, c),
        jnp.asarray(normwin).reshape(b * p, lm, c), W,
    )
    lens_b = jnp.asarray(np.broadcast_to(np.array(lens, np.int32), (b, p)).reshape(-1))
    return np.asarray(jax_banded_dtw_batch(costs, lens_b, W)).reshape(b, p)


def _linear(x: dict) -> np.ndarray:
    F = x["win"].shape[0]
    order = [(x["rot"] + 1 + i) % F for i in range(LM)]
    return np.transpose(x["win"][order], (2, 0, 1))  # (B, Lm, C)


@pytest.fixture(scope="module")
def jax_v3():
    """The JAX K2 wrapper in interpret mode, compiled once for every gate."""
    return jax.jit(lambda win, means, tpl, tn, gate, rot: jax_fused_dtw_batch_v3_t(
        win, means, tpl, tn, gate, LENS, W, D, K, rot, interpret=True))


def _assert_gated(got, want, gate):
    """Template sims are finite exactly where the stream's avg passes its
    wakeword's bound, and equal there; avg sims are always equal."""
    for d in range(D):
        passing = want[:, D * K + d] <= gate[d]
        tpl = got[:, d * K:(d + 1) * K]
        np.testing.assert_array_equal(np.isfinite(tpl), np.repeat(passing[:, None], K, 1))
        np.testing.assert_allclose(tpl[passing], want[:, d * K:(d + 1) * K][passing],
                                   rtol=RTOL, atol=ATOL_V3)
    np.testing.assert_allclose(got[:, D * K:], want[:, D * K:], rtol=RTOL, atol=ATOL_V3)


@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
def test_k2_plain_version_matches_jax_pallas_kernel_interpret(jax_v3, gate):
    x = _v3_inputs(LM + 9)
    args = [jnp.asarray(x[k]) for k in ("win", "means", "templates", "tnorms")]
    rot = jnp.asarray(x["rot"], jnp.int32)
    open_ = np.full((D,), np.inf, np.float32)
    want = np.asarray(jax_v3(*args, jnp.asarray(open_), rot))
    avg0 = want[:, D * K]
    bound = {"open": open_,
             "closed": np.array([avg0.min() - 1.0, np.inf], np.float32),
             "mixed": np.array([np.median(avg0), np.inf], np.float32)}[gate]
    got = fd.fused_dtw_batch_v3_ref(*_v3_args(x, bound)).numpy()
    assert got.shape == (B, P)
    if gate == "mixed":
        assert 0 < (avg0 <= bound[0]).sum() < B
    if gate == "closed":
        # no stream passes: the TPU's tile skip and the per-stream gate agree
        jax_closed = np.asarray(jax_v3(*args, jnp.asarray(bound), rot))
        assert np.all(np.isinf(jax_closed[:, :K])) and np.all(np.isinf(got[:, :K]))
    _assert_gated(got, want, bound)


@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_k2_plain_version_matches_scan_oracle(F):
    x = _v3_inputs(F)
    want = _scan_oracle(_linear(x), np.transpose(x["means"], (2, 0, 1)), x["templates"], LENS)
    got = fd.fused_dtw_batch_v3_ref(*_v3_args(x, [np.inf, np.inf])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_V3, err_msg=f"F={F}")


def test_k2_wrappers_on_cpu_are_the_plain_version():
    x = _v3_inputs(LM + 2)
    args = _v3_args(x, [np.inf, 1.0])
    want = fd.fused_dtw_batch_v3_ref(*args)
    before = dict(fd.LAUNCHES)
    torch.testing.assert_close(fd.fused_dtw_batch_v3_t(*args), want, rtol=0, atol=0)
    tset = fd.prepare_templates(args[2], args[3], LENS, W)
    torch.testing.assert_close(fd.score_shift(args[0], args[1], tset, args[4], D, K, args[9]),
                               want, rtol=0, atol=0)
    # the (B, F, C) layout; rot=None means a linear window (rot = F - 1)
    win_b, means_b = args[0].permute(2, 0, 1), args[1].permute(2, 0, 1)
    lin_rot = t(x["win"].shape[0] - 1, dtype=torch.int32)
    torch.testing.assert_close(
        fd.fused_dtw_batch_v3(win_b, means_b, *args[2:9]),
        fd.fused_dtw_batch_v3_ref(*args[:9], lin_rot), rtol=0, atol=0)
    assert fd.LAUNCHES == before  # the plain path launches nothing


def test_k2_bad_arguments_raise():
    args = list(_v3_args(_v3_inputs(LM), [np.inf, np.inf]))
    with pytest.raises(ValueError, match="means_t"):
        fd.fused_dtw_batch_v3_t(args[0], args[1][:, :-1], *args[2:])
    with pytest.raises(ValueError, match="F=39"):
        fd.fused_dtw_batch_v3_t(args[0][:-1], *args[1:])
    with pytest.raises(ValueError, match="band_size >= 2"):
        fd.fused_dtw_batch_v3_t(*args[:6], 1, *args[7:])
    with pytest.raises(ValueError, match="rot"):
        fd.fused_dtw_batch_v3_t(*args[:9], t([3]))


# K4: the shapes of tests/test_dtw_and_scoring.py::test_fused_kernel_matches_unfused
B4, LM4, P4 = 50, 60, 4
LENS4 = (60, 41, 33, 55)


def _v2_inputs():
    rng = np.random.default_rng(3)
    templates = rng.normal(0, 1, (P4, LM4, C)).astype(np.float32)
    return dict(
        win=rng.normal(0, 1, (B4, LM4, C)).astype(np.float32),
        means=rng.normal(0, 0.2, (B4, P4, C)).astype(np.float32),
        templates=templates,
        tnorms=np.sum(templates ** 2, axis=-1).astype(np.float32),
    )


def test_k4_plain_version_matches_jax_pallas_kernel_interpret():
    x = _v2_inputs()
    names = ("win", "means", "templates", "tnorms")
    want = np.asarray(jax_fused_dtw_batch(*[jnp.asarray(x[k]) for k in names], LENS4, W,
                                          interpret=True))
    got = fd.fused_dtw_batch_ref(*[t(x[k]) for k in names], LENS4, W).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_V2)
    oracle = _scan_oracle(x["win"], x["means"], x["templates"], LENS4)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL_V2)


def test_k4_wrappers_on_cpu_and_variant_1():
    x = _v2_inputs()
    args = [t(x[k]) for k in ("win", "means", "templates", "tnorms")]
    want = fd.fused_dtw_batch_ref(*args, LENS4, W)
    before = dict(fd.LAUNCHES)
    torch.testing.assert_close(fd.fused_dtw_batch(*args, LENS4, W), want, rtol=0, atol=0)
    tset = fd.prepare_templates(args[2], args[3], LENS4, W)
    got = fd.score_linear(args[0].permute(1, 2, 0).contiguous(),
                          args[1].permute(1, 2, 0).contiguous(), tset)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # variant 1 (K5) computes the same function: on the CPU, the same plain version
    torch.testing.assert_close(fd.fused_dtw_batch(*args, LENS4, W, variant=1), want,
                               rtol=0, atol=0)
    assert fd.LAUNCHES == before
    with pytest.raises(ValueError, match="means"):
        fd.fused_dtw_batch(args[0], args[1][:, :-1], *args[2:], LENS4, W)


# K3: the shapes of tests/test_dtw_and_scoring.py::test_banded_dtw_backends_match_oracle
def test_k3_plain_version_is_bit_exact_against_jax_pallas_kernel_interpret():
    rng = np.random.default_rng(0)
    n, L = 37, 60
    lens = rng.integers(20, L + 1, n).astype(np.int32)
    a = rng.normal(0, 1, (n, L, C)).astype(np.float32)
    b = rng.normal(0, 1, (n, L, C)).astype(np.float32)
    costs = np.asarray(jax_band_costs(jnp.asarray(a), jnp.asarray(b), W))
    want = np.asarray(banded_dtw_pallas(jnp.asarray(costs), jnp.asarray(lens), W,
                                        interpret=True))
    got = banded_dtw_batch(t(costs), t(lens), W).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's band costs agree with JAX's to float rounding
    np.testing.assert_allclose(band_costs(t(a), t(b), W).numpy(), costs, rtol=1e-6, atol=1e-6)


def test_k3_wrapper_and_dispatch_on_cpu():
    rng = np.random.default_rng(1)
    costs = t(rng.uniform(0, 2, (33, 30, 2 * W)).astype(np.float32))
    lens = t(rng.integers(1, 31, 33).astype(np.int32))
    want = banded_dtw_batch(costs, lens, W)
    before = dict(bd.LAUNCHES)
    torch.testing.assert_close(bd.banded_dtw_kernel(costs, lens, W), want, rtol=0, atol=0)
    torch.testing.assert_close(get_banded_dtw(W)(costs, lens), want, rtol=0, atol=0)
    assert bd.LAUNCHES == before
    assert torch.isinf(want[lens < 2]).all()
    with pytest.raises(ValueError, match="costs"):
        bd.banded_dtw_kernel(costs[:, :, 1:], lens, W)
    with pytest.raises(ValueError, match="lengths"):
        bd.banded_dtw_kernel(costs, lens[1:], W)
