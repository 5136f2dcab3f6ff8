"""K5 of the PyTorch port (`fused_dtw_batch(variant=1)`, csrc/fused_dtw_v1.cu)
against the JAX package on the CPU: its plain version against the JAX Pallas
kernel `_kernel` (v1) in interpret mode and against the scan-path oracle, and
the wrappers' CPU dispatch. The hand-written kernel is held against the plain
version on the card in tests/test_torch_cuda.py.

Tolerance: rtol 3e-6 / atol 1e-4 on similarities (sums of up to 60 cosine
costs), the JAX kernel tests' own for the linear-window kernels
(tests/test_dtw_and_scoring.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu.ops.dtw import band_costs as jax_band_costs
from rustpotter_tpu.ops.dtw import banded_dtw_batch as jax_banded_dtw_batch
from rustpotter_tpu.ops.fused_dtw import fused_dtw_batch as jax_fused_dtw_batch
from rustpotter_tpu_torch.ops import fused_dtw as fd

torch.set_num_threads(2)

RTOL, ATOL = 3e-6, 1e-4
W = 5
# the K4 test shapes (tests/test_torch_kernels_v2_v3.py)
B, LM, C = 50, 60, 8
LENS = (60, 41, 33, 55)
P = len(LENS)
NAMES = ("win", "means", "templates", "tnorms")


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(3)
    templates = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    return dict(
        win=rng.normal(0, 1, (B, LM, C)).astype(np.float32),
        means=rng.normal(0, 0.2, (B, P, C)).astype(np.float32),
        templates=templates,
        tnorms=np.sum(templates ** 2, axis=-1).astype(np.float32),
    )


def _scan_oracle(x) -> np.ndarray:
    normwin = x["win"][:, None] - x["means"][:, :, None]  # (B, P, Lm, C)
    costs = jax_band_costs(
        jnp.asarray(np.broadcast_to(x["templates"], (B, P, LM, C))).reshape(B * P, LM, C),
        jnp.asarray(normwin).reshape(B * P, LM, C), W,
    )
    lens_b = jnp.asarray(np.tile(np.array(LENS, np.int32), B))
    return np.asarray(jax_banded_dtw_batch(costs, lens_b, W)).reshape(B, P)


def test_k5_plain_version_matches_jax_pallas_kernel_interpret(x):
    want = np.asarray(jax_fused_dtw_batch(*[jnp.asarray(x[k]) for k in NAMES], LENS, W,
                                          interpret=True, variant=1))
    got = fd.fused_dtw_batch_ref(*[torch.tensor(x[k]) for k in NAMES], LENS, W).numpy()
    assert got.shape == (B, P)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _scan_oracle(x), rtol=RTOL, atol=ATOL)


def test_k5_wrappers_on_cpu_are_the_plain_version(x):
    args = [torch.tensor(x[k]) for k in NAMES]
    want = fd.fused_dtw_batch_ref(*args, LENS, W)
    before = dict(fd.LAUNCHES)
    torch.testing.assert_close(fd.fused_dtw_batch(*args, LENS, W, variant=1), want,
                               rtol=0, atol=0)
    tset = fd.prepare_templates(args[2], args[3], LENS, W)
    got = fd.score_linear(args[0].permute(1, 2, 0).contiguous(),
                          args[1].permute(1, 2, 0).contiguous(), tset, variant=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fd.LAUNCHES == before  # the plain path launches nothing


@pytest.mark.parametrize("variant", [0, 3])
def test_fused_dtw_batch_refuses_other_variants(x, variant):
    args = [torch.tensor(x[k]) for k in NAMES]
    with pytest.raises(ValueError, match="unknown variant"):
        fd.fused_dtw_batch(*args, LENS, W, variant=variant)
