"""The port's kernel tools on the CPU: rustpotter_tpu_torch.tools.kernel_parity
runs its seven checks at B = 33 (the wrappers run their plain versions on CPU
tensors, which checks the tool's inputs, oracle and virtual-window
bookkeeping), kernel_probe's modes (K3's against the plain DP, bit for bit)
build their calls and bounds, and kernel_probe, kernel_parity and fma_probe refuse to run
without a card or with arguments they do not take. On the card kernel_parity
runs at B = 8192 in tests/test_torch_cuda.py; kernel_probe and fma_probe time
the kernels there."""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.ops.dtw import banded_dtw_batch
from rustpotter_tpu_torch.tools import fma_probe, kernel_parity, kernel_probe
from rustpotter_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs():
    return kernel_parity.make_inputs(33)


@pytest.mark.parametrize("check", kernel_parity.CHECKS, ids=lambda c: c.__name__)
def test_kernel_parity_check_on_cpu(inputs, check):
    line = check(inputs, torch.device("cpu"))
    assert line.startswith(check.__name__[-1] + ".") and "OK" in line


def test_kernel_parity_inputs_follow_the_jax_tool():
    x = kernel_parity.make_inputs(5000)
    assert x["win"].shape == (5000, 100, 16) and x["means3"].shape == (3, 6, 16, 5000)
    assert x["w6"].shape == (100, 16, 4096) and x["m7"].shape == (3, 18, 16, 2048)
    # the first draws are the JAX tool's: seed 7, win first
    want = np.random.default_rng(7).normal(0, 1, (5000, 100, 16)).astype(np.float32)
    np.testing.assert_array_equal(x["win"], want)


@pytest.mark.parametrize("tool,argv", [
    (kernel_probe, ["--v1"]), (kernel_parity, ["33"]), (fma_probe, []),
])
def test_tools_need_a_card(tool, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run on it")
    assert tool.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("tool,argv", [
    (kernel_probe, ["--jch=3"]), (kernel_probe, ["1", "2", "3"]),
    (kernel_probe, ["--k3", "--gate"]), (kernel_probe, ["--k3", "--v1"]),
    (kernel_parity, ["--v1"]), (fma_probe, ["8"]),
])
def test_tools_refuse_arguments_they_do_not_take(tool, argv, capsys):
    assert tool.main(argv) == 2
    err = capsys.readouterr().err
    assert "usage" in err or "no arguments" in err


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_kernel_probe_calls_and_bounds_on_cpu(variant):
    flag = {0: ["--k3"], 1: ["--v1"], 2: ["--v2"], 3: [], 4: ["--v4"]}[variant]
    B, iters, v, gate = kernel_probe.parse(["40", "3", *flag])
    assert (B, iters, v, gate) == (40, 3, variant, False)
    x = kernel_probe.inputs(B, variant, "cpu")
    whole, _, (flops, nbytes) = kernel_probe.calls(x, variant, gate)
    sims = whole()
    if variant == 0:  # K3: 6B DPs, bit for bit the plain DP; no gate
        assert sims.shape == (B * 6,) and torch.isfinite(sims).all()
        torch.testing.assert_close(sims, banded_dtw_batch(x["costs"], x["lens"], 5),
                                   rtol=0, atol=0)
        rows = B * sum(n - 1 for n in kernel_probe.LENS)
        assert (flops, nbytes) == (rows * 38, 4 * (rows * 10 + 2 * B * 6))
        assert kernel_probe.calls(x, 0, True)[2] == (flops, nbytes)
        return
    assert sims.shape == ((B, 3, 6) if variant == 4 else (B, 6))
    assert torch.isfinite(sims).all()
    if variant in (1, 2):
        torch.testing.assert_close(sims, fd.fused_dtw_batch_ref(
            x["win"], x["means"], x["templates"], x["tnorms"], kernel_probe.LENS, 5))
    # a closed gate leaves K1 and K2 the avg pairs' work only
    _, _, (gated, _) = kernel_probe.calls(x, variant, True)
    assert gated < flops if variant in (3, 4) else gated == flops
    assert nbytes > 0



def test_kernel_probe_mixed_shapes_on_cpu():
    """--mixed: K1 at the `mixed` cell's shapes (three wakewords of 8
    templates, 100 ... 46 frames, and their avg pairs, P = 27, F = 168)
    scores every pair, and with --gate only the avg pairs; it takes no other
    kernel."""
    B, iters, v, gate = kernel_probe.parse(["40", "3", "--mixed"])
    assert (B, iters, v, gate) == (40, 3, 4, False)
    at = kernel_probe.shapes(["40", "--mixed"])
    assert at is kernel_probe.MIXED and kernel_probe.shapes([]) is kernel_probe.BENCH
    assert (len(at.lens), at.D, at.K, at.F) == (27, 3, 8, 168)
    assert (at.lens[0], at.lens[23], at.lens[24:]) == (100, 46, (100, 80, 60))
    x = kernel_probe.inputs(B, 4, "cpu", 5, at)
    whole, _, (flops, nbytes) = kernel_probe.calls(x, 4, False, 5, at)
    sims = whole()
    assert sims.shape == (B, 3, 27) and torch.isfinite(sims).all()
    assert nbytes == profiling.k1_bytes(168, 16, B, 27, 100)
    _, _, (gated, _) = kernel_probe.calls(x, 4, True, 5, at)
    assert gated == sum(profiling.k1_work(at.lens[24:], 5, 16, B)) < flops
    for argv in (["--mixed", "--v2"], ["--mixed", "--k3"]):
        with pytest.raises(ValueError):
            kernel_probe.parse(argv)


@pytest.mark.parametrize("variant,closed", [(3, 0.0925), (4, 0.0956), (1, None)])
def test_kernel_probe_report_gives_the_gate_closed_time(variant, closed):
    """K1 and K2 report their gate-closed launch beside the gate-open one."""
    r = dict(B=8192, variant=variant, gate=False, ms=0.2, ms_gate_closed=closed,
             bound_ms=0.03, bound_by="operations", flops=2e9, bytes=7.5e7,
             kernels=[(0.2, 2.0, "score_pairs")])
    head = kernel_probe.report(r)[0]
    assert "200.0 us per launch" in head
    assert ("gate closed" in head) == (closed is not None)
    if closed is not None:
        assert f"gate closed {closed * 1e3:.1f} us per launch" in head


@pytest.mark.parametrize("w", [5, 21, 24])
def test_kernel_probe_band_on_cpu(w):
    """--w=N: K4 past its ring (w > 19, its column form on the card) scores the
    plain DP at that band, and the bound counts `dp_work` at it."""
    argv = ["40", "3", "--v2"] + ([] if w == 5 else [f"--w={w}"])
    B, iters, v, gate = kernel_probe.parse(argv)
    assert (B, v, kernel_probe.band(argv)) == (40, 2, w)
    x = kernel_probe.inputs(B, v, "cpu", w)
    whole, _, (flops, _) = kernel_probe.calls(x, v, gate, w)
    torch.testing.assert_close(whole(), fd.fused_dtw_batch_ref(
        x["win"], x["means"], x["templates"], x["tnorms"], kernel_probe.LENS, w))
    assert flops == B * sum(profiling.dp_work(n, w, 16, True) for n in kernel_probe.LENS)


@pytest.mark.parametrize("argv", [["--w=1"], ["--w=x"], ["--w=3", "--w=4"], ["--w="]])
def test_kernel_probe_refuses_a_bad_band(argv, capsys):
    assert kernel_probe.main(argv) == 2
    assert "usage" in capsys.readouterr().err
