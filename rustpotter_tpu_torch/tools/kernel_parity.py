"""Kernel parity on the card: the port's DTW kernels against the plain
band-cost + banded-DP oracle on the same device. The counterpart of the JAX
package's tools/tpu_kernel_parity.py, with its shapes, seeds and tolerances:

    python -m rustpotter_tpu_torch.tools.kernel_parity [B]    # needs a card

Checks (the oracle is `ops.dtw.band_costs` + `ops.dtw.banded_dtw_batch` on
the CMN-normalized linear windows):
  1. K3 (`banded_dtw_kernel`) equals the oracle's DP bit for bit;
  2. K4 (`fused_dtw_batch`, variant 2): rtol 3e-6 / atol 1e-4;
  3. K2 (`fused_dtw_batch_v3`), gate off: rtol 3e-6 / atol 2e-4;
  4. K2's gate: a bound below every stream's avg sim writes +inf template
     sims and keeps the avg sims; a bound above every avg sim reproduces the
     ungated sims exactly;
  5. K1 (`fused_dtw_chunk_v4`, a wrap-around cursor) against the oracle on
     each shift's virtual window: rtol 3e-6 / atol 2e-4;
  6. K1 at P = 11 (one wakeword of K = 10, B <= 4096);
  7. K1 at D = 2, K = 8, P = 18 (B <= 2048).
Each check takes a device: on the card the wrappers launch the kernels, on
the CPU they run their plain versions (which the tests use to check the
tool's own bookkeeping).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import banded_dtw as bd
from ..ops import fused_dtw as fd
from ..ops.dtw import band_costs, banded_dtw_batch

LM, C, W = 100, 16, 5
LENS = (100, 98, 96, 94, 92, 97)
D, K = 1, 5
RTOL, ATOL, ATOL_V2 = 3e-6, 2e-4, 1e-4


def make_inputs(B: int) -> dict:
    """Every check's inputs as numpy arrays: the JAX tool's draws from seed 7,
    in its order."""
    rng = np.random.default_rng(7)
    P = len(LENS)
    f32 = lambda a: a.astype(np.float32)
    x = dict(B=B)
    x["win"] = f32(rng.normal(0, 1, (B, LM, C)))
    x["means"] = f32(rng.normal(0, 0.2, (B, P, C)))
    x["templates"] = f32(rng.normal(0, 1, (P, LM, C)))
    # 5: the whole chunk, F = Lm
    x["win_t"] = f32(rng.normal(0, 1, (LM, C, B)))
    x["new_t"] = f32(rng.normal(0, 1, (3, C, B)))
    x["means3"] = f32(rng.normal(0, 0.2, (3, P, C, B)))
    # 6: one wakeword of K = 10, P = 11
    B6 = min(B, 4096)
    x["t6"] = f32(rng.normal(0, 1, (11, LM, C)))
    x["w6"] = f32(rng.normal(0, 1, (LM, C, B6)))
    x["nw6"] = f32(rng.normal(0, 1, (3, C, B6)))
    x["m6"] = f32(rng.normal(0, 0.2, (3, 11, C, B6)))
    # 7: two wakewords of K = 8, P = 18
    B7 = min(B, 2048)
    x["t7"] = f32(rng.normal(0, 1, (18, LM, C)))
    x["w7"] = f32(rng.normal(0, 1, (LM, C, B7)))
    x["nw7"] = f32(rng.normal(0, 1, (3, C, B7)))
    x["m7"] = f32(rng.normal(0, 0.2, (3, 18, C, B7)))
    return x


def _t(a, device):
    return torch.tensor(a, device=device)


def _costs(lin, means, templates, device):
    """Band costs (B·P, Lm, 2w) of every (stream, pair): lin (B, Lm, C) and
    means (B, P, C) numpy, templates (P, Lm, C) raw."""
    B, P = means.shape[:2]
    lin_t, m_t, tpl = _t(lin, device), _t(means, device), _t(templates, device)
    normwin = lin_t[:, None] - m_t[:, :, None]  # (B, P, Lm, C)
    return band_costs(tpl.expand(B, P, LM, C).reshape(B * P, LM, C),
                      normwin.reshape(B * P, LM, C), W)


def _lens_b(lens, B, device):
    return _t(np.tile(np.asarray(lens, np.int32), B), device)


def oracle(lin, means, templates, lens, device) -> torch.Tensor:
    """Sims (B, P) of the linear windows lin (B, Lm, C) by the plain band
    costs and banded DP."""
    B, P = means.shape[:2]
    costs = _costs(lin, means, templates, device)
    return banded_dtw_batch(costs, _lens_b(lens, B, device), W).reshape(B, P)


def _close(got, want, atol, what):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=atol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def _tnorms(tpl):
    return torch.sum(tpl * tpl, dim=-1)


def check_1(x, device):
    B, P = x["means"].shape[:2]
    costs = _costs(x["win"], x["means"], x["templates"], device)
    lens_b = _lens_b(LENS, B, device)
    got = bd.banded_dtw_kernel(costs, lens_b, W)
    want = banded_dtw_batch(costs, lens_b, W)
    if not torch.equal(got, want):
        raise AssertionError(f"1. K3 differs from the DP in {int((got != want).sum())} entries")
    return "1. K3 banded_dtw == the plain DP (bit-exact) OK"


def _k2(x, device, bound):
    tpl = _t(x["templates"], device)
    return fd.fused_dtw_batch_v3(_t(x["win"], device), _t(x["means"], device), tpl,
                                 _tnorms(tpl), _t(np.float32([bound]), device), LENS, W, D, K)


def check_2(x, device):
    tpl = _t(x["templates"], device)
    got = fd.fused_dtw_batch(_t(x["win"], device), _t(x["means"], device), tpl, _tnorms(tpl),
                             LENS, W, variant=2)
    want = oracle(x["win"], x["means"], x["templates"], LENS, device)
    d = _close(got, want, ATOL_V2, "2. K4")
    return f"2. K4 fused_dtw_v2 vs the oracle (rtol 3e-6/atol 1e-4) OK, max |d| = {d:.3e}"


def check_3(x, device):
    want = oracle(x["win"], x["means"], x["templates"], LENS, device)
    d = _close(_k2(x, device, np.inf), want, ATOL, "3. K2")
    return f"3. K2 fused_dtw_v3 (gate off) vs the oracle OK, max |d| = {d:.3e}"


def check_4(x, device):
    v3 = _k2(x, device, np.inf)
    avg = v3[:, D * K]
    low = _k2(x, device, float(avg.min()) - 1.0)
    if not torch.isinf(low[:, :D * K]).all():
        raise AssertionError("4. K2: gated-out template sims must be +inf")
    _close(low[:, D * K:], v3[:, D * K:], ATOL, "4. K2 avg sims under a closed gate")
    high = _k2(x, device, float(avg.max()) + 1.0)
    if not torch.equal(high, v3):
        raise AssertionError("4. K2: a gate every stream passes must give the ungated sims")
    return "4. K2 gating semantics OK"


def _chunk_check(x, device, tpl_np, win_t, new_t, means3, lens, D_, K_, what):
    """K1 on one chunk (cursor F - 2: the new rows wrap around) against the
    oracle on each shift's virtual window."""
    F = win_t.shape[0]
    rot0 = F - 2
    tpl = _t(tpl_np, device)
    got = fd.fused_dtw_chunk_v4(
        _t(win_t, device), _t(new_t, device), _t(means3, device), tpl, _tnorms(tpl),
        torch.full((D_,), float("inf"), device=device), lens, W, D_, K_,
        torch.tensor(rot0, dtype=torch.int32, device=device))  # (B, 3, P)
    virt = win_t.copy()
    worst = 0.0
    for s in range(3):
        virt[(rot0 + 1 + s) % F] = new_t[s]
        rot_s = (rot0 + s + 1) % F
        order = [(rot_s + 1 + i) % F for i in range(LM)]
        lin = np.transpose(virt[order], (2, 0, 1))  # (B, Lm, C)
        want = oracle(lin, np.transpose(means3[s], (2, 0, 1)), tpl_np, lens, device)
        worst = max(worst, _close(got[:, s], want, ATOL, f"{what}, shift {s}"))
    return worst


def check_5(x, device):
    d = _chunk_check(x, device, x["templates"], x["win_t"], x["new_t"], x["means3"], LENS,
                     D, K, "5. K1")
    return f"5. K1 fused_dtw_v4 whole chunk vs the per-shift oracle OK, max |d| = {d:.3e}"


def check_6(x, device):
    lens6 = tuple(100 - 2 * (i % 5) for i in range(10)) + (100,)
    d = _chunk_check(x, device, x["t6"], x["w6"], x["nw6"], x["m6"], lens6, 1, 10, "6. K1")
    return f"6. K1 at one wakeword of K = 10 (P = 11) OK, max |d| = {d:.3e}"


def check_7(x, device):
    lens7 = tuple(100 - 2 * (i % 5) for i in range(16)) + (100,) * 2
    d = _chunk_check(x, device, x["t7"], x["w7"], x["nw7"], x["m7"], lens7, 2, 8, "7. K1")
    return f"7. K1 at D = 2, K = 8 (P = 18) OK, max |d| = {d:.3e}"


CHECKS = (check_1, check_2, check_3, check_4, check_5, check_6, check_7)


def run(B: int, device) -> list:
    """Every check at B streams on `device`; raises at the first that fails.
    Returns the checks' lines."""
    x = make_inputs(B)
    lines = []
    for check in CHECKS:
        lines.append(check(x, device))
        print(lines[-1], flush=True)
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 or (argv and not argv[0].isdigit()):
        print(f"kernel_parity: usage [B], got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_parity: no CUDA device; the kernels run only on the card",
              file=sys.stderr)
        return 2
    B = int(argv[0]) if argv else 8192
    run(B, torch.device("cuda"))
    print(f"KERNEL PARITY OK on {torch.cuda.get_device_name(0)} B={B}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
