"""The control: the reference computed with TF32 products, in the program's
place, fails the comparison that decides `correct` (see control.py)."""
import pytest
import torch

from portbench import control
from portbench.reference.products import matmul, round_tf32

TINY = {"streams": 8, "utterance_every": 4, "check_streams": 6, "check_utterance": 2,
        "check_near": 2}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -12, -3.0])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]
    a = torch.randn(64, 64, dtype=torch.float64)
    err = (matmul(a, a, "tf32").double() - a @ a).abs().max() / (a @ a).abs().max()
    assert 1e-4 < err < 1e-2


@pytest.mark.parametrize("cell", ["dtw_bench.backlog", "nn_medium.serve"])
def test_tf32_products_fail_the_comparison(cell):
    r = control.readings(cell, 7, 140, "cpu", TINY)
    assert r["numbers"]["reference_fires"] >= 1
    assert not all(v["ok"] for v in r["checks"].values()), r["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dtw_bench.backlog", "nn_medium.backlog"])
def test_tf32_products_fail_the_comparison_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = control.readings(cell, 11, 264, "cuda", {"streams": 4096, "check_streams": 16})
    assert r["numbers"]["reference_fires"] >= 1
    assert not all(v["ok"] for v in r["checks"].values()), r["numbers"]
