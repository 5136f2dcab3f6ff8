"""K4's schedule (csrc/fused_dtw_v2.cu) on the CPU: numpy transcriptions of
the kernel's loops, held against the plain version `fused_dtw_batch_ref`.

The transcription follows the .cu step for step: one launch, a block of 32
lanes x (Q producer warps + the DP warp) of one pair, the dotm prologue
(rows -w+1 ... Q-1+w split over the producers) and its barrier, the rounds
of Q columns, each producer's unguarded column step (its column loaded a
round ahead and clamped, the dotm row k+Q+w of its next column, rwn, 2w
costs of clamped rows against the dotm ring, predicated stores at the
incrementally counted ring row), the shared cost ring of 2w+2Q-1 rows x 2w
band slots and the dotm ring of 2w+2Q-1 rows, the DP warp's Q DP steps per
round and its harvest. Both rings start as NaN, and each slot records the
template row it holds, which every read of a valid row checks: a slot read
before it is written, or after another row overwrote it, fails. Each round
runs in the worst order for the rings: every producer's dotm writes of a
round before any producer's reads in it (they race between two barriers),
and every producer's writes of round u+1 before the DP warp's reads of
round u (which run between the same two barriers). So a ring too short to
hold a row until its last read fails here too: 2w+2Q-2 rows fail it, for
either ring. Pairs are long enough (n >= 3w+3Q+1) that a ring row is reused
at every place in a round. FLOPs are counted as the kernel executes them and
held to `utils.profiling.k4_executed`.

The row form (w > W_MAX) is transcribed too: one thread per (stream, pair)
takes the DP rows in order, each cell with its clamped window column.

It also pins the wrapper's mirror of the .cu (`k4_form`, `k4_smem_bytes`,
K4_W_MAX, K4_PRODUCERS) to the .cu constants, evaluated by the host C++
compiler, on both sides of the change of form.

Tolerance: rtol 3e-6 / atol 1e-4 with an equal +inf pattern (the JAX kernel
tests'). The transcription rounds each product of a dot before adding it
where the kernel fuses them, and takes 1/sqrt where the kernel takes rsqrtf.
"""
import re

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import _build
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.utils import profiling
from test_torch_k3_schedule import _cu_constants

RTOL, ATOL = 3e-6, 1e-4
LANES = 32
Q = fd.K4_PRODUCERS
W_MAX = fd.K4_W_MAX
# pairs of n = 1 and 2, and pairs long enough that a ring row is reused at
# every place in a round up to w = W_MAX (n >= 3w + 3Q + 1 = 70)
LM, C = 80, 4
LENS = (LM, 2, 1, 71, 36, 9)
P = len(LENS)


def _dot(t, x):
    """One fp32 chain over c in order: t (C,), x (C, LANES)."""
    acc = t[0] * x[0]
    for c in range(1, len(t)):
        acc = (acc + t[c] * x[c]).astype(np.float32)
    return acc


def k4_schedule(win, means, tpl, lens, w, cost_rows=None, dotm_rows=None):
    """The kernel's sims (P, B) and the FLOPs it executed: win (Lm, C, B),
    means (P, C, B), tpl the padded T' (P, w + Lm + w, C). `cost_rows` and
    `dotm_rows` replace the kernel's 2w+2Q-1 rows of either ring."""
    _, Cn, Bn = win.shape
    W2 = 2 * w
    Rc = cost_rows or W2 + 2 * Q - 1
    Rd = dotm_rows or W2 + 2 * Q - 1
    out = np.full((len(lens), Bn), np.nan, np.float32)
    flops = [0]
    inf = np.float32(np.inf)

    def block(by, p):
        lane = np.arange(LANES)
        b = by * LANES + lane
        live = b < Bn
        bl = np.where(live, b, Bn - 1)
        n = lens[p]
        if n < 2:
            out[p, b[live]] = inf
            return
        nlive = int(live.sum())
        m = means[p][:, bl]  # (C, LANES)
        tp = lambda t: tpl[p, min(max(t, 0), n - 2) + w]  # clamped into 0 ... n-2
        column = lambda i: win[i][:, bl]

        ring = np.full((Rc * W2, LANES), np.nan, np.float32)
        held = np.full(Rc * W2, -1)  # the template row whose cost each slot holds
        dring = np.full((Rd, LANES), np.nan, np.float32)
        dheld = np.full(Rd, -10 ** 6)  # the template row whose dotm each slot holds
        kend = n + w - 2
        rounds = -(-kend // Q)

        def make_dotm(t, slot):
            dring[slot] = _dot(tp(t), m)
            dheld[slot] = t
            flops[0] += 2 * Cn * nlive

        # the prologue: rows -w+1 ... Q-1+w, producer g from row -w+g, then a barrier
        for g in range(1, Q + 1):
            for t in range(-w + g, Q + w, Q):
                make_dotm(t, t % Rd)
        # each producer's registers: column k, its next column (loaded a round
        # ahead) and the ring rows of template row k + w
        prod = [dict(k=g - 1, nxt=column(min(g - 1, n - 1)), base=(g - 1 + w) % Rc,
                     dbase=(g - 1 + w) % Rd) for g in range(1, Q + 1)]

        def produce():
            """Every producer's round: the dotm writes first, then the columns."""
            for st in prod:
                if st["k"] < kend:
                    make_dotm(st["k"] + Q + w, (st["dbase"] + Q) % Rd)
            for st in prod:
                k = st["k"]
                if k < kend:
                    x = st["nxt"]
                    st["nxt"] = column(min(k + Q, n - 1))
                    acc = np.zeros(LANES, np.float32)
                    for c in range(Cn):
                        dd = x[c] - m[c]
                        acc = (acc + dd * dd).astype(np.float32)
                    with np.errstate(divide="ignore"):
                        rw = np.where((k < n) & (acc != 0), 1 / np.sqrt(acc), 0).astype(np.float32)
                    for j in range(W2):
                        t = k + w - j
                        drow = (st["dbase"] - j) % Rd
                        if 0 <= t <= n - 2 and dheld[drow] != t:
                            raise AssertionError(f"dotm ring slot {drow} read for row {t} holds "
                                                 f"row {dheld[drow]}")
                        cost = 1 - (_dot(tp(t), x) - dring[drow]) * rw
                        row = st["base"] - j + (Rc if st["base"] - j < 0 else 0)
                        if 0 <= t <= n - 2:
                            ring[row * W2 + j] = cost
                            held[row * W2 + j] = t
                    flops[0] += (3 * Cn + 1 + W2 * (2 * Cn + 3)) * nlive  # + its dotm row
                st["k"] = k + Q
                st["base"] = st["base"] + Q - (Rc if st["base"] + Q >= Rc else 0)
                st["dbase"] = (st["dbase"] + Q) % Rd

        dp = dict(t=-w + 1, row=Rc - w + 1,
                  prev=np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                                 for j in range(W2)]))

        def take_rows():
            """The DP warp's Q rows of a round, after its barrier."""
            for _ in range(Q):
                t, row = dp["t"], dp["row"]
                dp["t"], dp["row"] = t + 1, 0 if row + 1 == Rc else row + 1
                if t < 0 or t > n - 2:
                    continue
                assert row == t % Rc
                r = t + 1
                hi = min(n, r + w - 1)
                cost = []
                for j in range(W2):
                    cdp = r - w + j
                    valid = 1 <= cdp <= hi
                    if valid and held[row * W2 + j] != t:
                        raise AssertionError(f"cost ring slot {row * W2 + j} read for row {t} "
                                             f"holds row {held[row * W2 + j]}")
                    cost.append(ring[row * W2 + j] if valid else np.full(LANES, inf))
                prev = dp["prev"]
                cur = [cost[j] + np.minimum(prev[j + 1] if j + 1 < W2 else inf, prev[j])
                       for j in range(W2)]
                for j in range(1, W2):
                    cur[j] = np.minimum(cur[j], cost[j] + cur[j - 1])
                dp["prev"] = np.stack(cur)
                flops[0] += (2 * W2 + 2 * (W2 - 1)) * nlive

        produce()
        for u in range(rounds):
            # between barrier u and u+1 the DP warp takes round u's rows while
            # the producers run round u+1; run in the worst order for the
            # ring: every producer's writes of round u+1 before those reads
            if u + 1 < rounds:
                produce()
            take_rows()
        out[p, b[live]] = dp["prev"][w + 1][live]

    for by in range(-(-Bn // LANES)):
        for p in range(len(lens)):
            block(by, p)
    return out, flops[0]


def k4_row_schedule(win, means, tpl, lens, w):
    """The row form's sims (P, B): one thread per (stream, pair), DP rows in
    order, each with its T' row, dotm and 2w cells of clamped columns."""
    _, Cn, Bn = win.shape
    W2 = 2 * w
    inf = np.float32(np.inf)
    out = np.full((len(lens), Bn), np.nan, np.float32)
    for p, n in enumerate(lens):
        if n < 2:
            out[p] = inf
            continue
        m = means[p]  # (C, B)
        prev = [np.zeros(Bn, np.float32) if j == w else np.full(Bn, inf) for j in range(W2)]
        for r in range(1, n):
            t = tpl[p, r - 1 + w]
            dm = _dot(t, m)
            hi = min(n, r + w - 1)
            cost = []
            for j in range(W2):
                cdp = r - w + j
                x = win[min(max(cdp - 1, 0), n - 1)]
                acc = np.zeros(Bn, np.float32)
                for c in range(Cn):
                    dd = x[c] - m[c]
                    acc = (acc + dd * dd).astype(np.float32)
                with np.errstate(divide="ignore"):
                    rw = np.where(acc != 0, 1 / np.sqrt(acc), 0).astype(np.float32)
                valid = 1 <= cdp <= hi
                cost.append(1 - (_dot(t, x) - dm) * rw if valid else np.full(Bn, inf))
            cur = [cost[j] + np.minimum(prev[j + 1] if j + 1 < W2 else inf, prev[j])
                   for j in range(W2)]
            for j in range(1, W2):
                cur[j] = np.minimum(cur[j], cost[j] + cur[j - 1])
            prev = cur
        out[p] = prev[w + 1]
    return out


def _inputs(B, seed):
    """win (B, Lm, C), means (B, P, C), raw templates and their squared row
    norms. Stream 0's window column 3 equals pair 0's mean, so its rwn is 0;
    template 1's first row is zero, and stays zero in T'."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    win = rng.normal(0, 1, (B, LM, C)).astype(np.float32)
    means = rng.normal(0, 0.2, (B, P, C)).astype(np.float32)
    win[0, 3] = means[0, 0]
    tpl = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    tpl[1, 0] = 0.0
    return t(win), t(means), t(tpl), t(np.sum(tpl ** 2, axis=-1))


def _run(win, means, templates, tnorms, w, **rows):
    tset = fd.prepare_templates(templates, tnorms, LENS, w)
    win_t, means_t = (a.permute(1, 2, 0).contiguous().numpy() for a in (win, means))
    return k4_schedule(win_t, means_t, tset.padded.numpy(), LENS, w, **rows)


@pytest.mark.parametrize("B", [35, 1])  # a short second block; 31 dead lanes
@pytest.mark.parametrize("w", [2, 5, W_MAX])
def test_schedule_matches_plain_version(w, B):
    win, means, templates, tnorms = _inputs(B, seed=10 * w + B)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, LENS, w).numpy()
    got, flops = _run(win, means, templates, tnorms, w)
    got = got.T  # (B, P), the wrapper's view
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    assert np.isinf(got[:, 2]).all() and fin[:, [0, 1, 3, 4, 5]].all()
    assert flops == profiling.k4_executed(LENS, w, C, B)


@pytest.mark.parametrize("w", [W_MAX + 1, 24])
def test_row_form_matches_plain_version(w):
    """The row form, past W_MAX: columns clamped into 0 ... n-1, pairs of
    length 1 and 2, a zero-norm column."""
    assert fd.k4_form(w) == "row"
    win, means, templates, tnorms = _inputs(35, seed=w)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, LENS, w).numpy()
    tset = fd.prepare_templates(templates, tnorms, LENS, w)
    win_t, means_t = (a.permute(1, 2, 0).contiguous().numpy() for a in (win, means))
    got = k4_row_schedule(win_t, means_t, tset.padded.numpy(), LENS, w).T
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("short", ["cost", "dotm"])
def test_rings_one_row_short_fail_the_schedule(short):
    """Both rings' bound is tight: with 2w+2Q-2 rows, a producer's store of
    round u+1 lands on a cost slot the DP warp still reads in round u, and a
    producer's dotm store of a round on a slot another producer still reads
    in it (row t whose last column t + w - 1 opens its round)."""
    w = 5
    win, means, templates, tnorms = _inputs(35, seed=7)
    with pytest.raises(AssertionError, match=rf"{short} ring slot \d+ read for row \d+ holds row"):
        _run(win, means, templates, tnorms, w, **{f"{short}_rows": 2 * w + 2 * Q - 2})


def test_executed_work_at_the_bench_shapes():
    """The design's FLOPs at the bench shapes: no fewer than the function
    needs (2.1716 GFLOP), and at most 10 % more."""
    lens = (100, 98, 96, 94, 92, 100)
    need = 8192 * sum(profiling.dp_work(n, 5, 16, True) for n in lens)
    done = profiling.k4_executed(lens, 5, 16, 8192)
    assert need == 2_171_617_280
    assert need <= done <= 1.10 * need
    assert done == 2_310_520_832


def test_k4_form_and_smem_follow_the_cu():
    """K4's form (RING_FORM, from RP_W alone), its producer warps, ring rows
    and shared memory, on both sides of W_MAX = 19, the largest band whose
    rings fit the opt-in; the row form takes the wider bands without
    shared memory, so K4's wrapper never refuses a band for it."""
    bands = range(2, 31)
    consts = _cu_constants("fused_dtw_v2.cu", ("RING_FORM", "Q", "R", "W_MAX", "RING_BYTES",
                                              "SMEM_BYTES"), bands, 16)
    for w in bands:
        c = consts[w]
        assert c["RING_FORM"] == (fd.k4_form(w) == "ring"), w
        assert (c["Q"], c["W_MAX"], c["R"]) == (Q, W_MAX, 2 * w + 2 * Q - 1), w
        assert c["SMEM_BYTES"] == fd.k4_smem_bytes(w, 16), w
        assert (c["RING_BYTES"] <= _build.SMEM_OPTIN) == (w <= W_MAX), w
        fd._check_smem("K4", fd.k4_smem_bytes(w, 16), w, 16)
    assert (fd.k4_form(W_MAX), fd.k4_form(W_MAX + 1)) == ("ring", "row")
    assert fd.k4_smem_bytes(5, 16) == 23_936 and fd.k4_smem_bytes(W_MAX + 1, 16) == 0
    text = (_build.CSRC / "fused_dtw_v2.cu").read_text()
    assert re.search(r"static_assert\(!RING_FORM \|\| RING_BYTES <= SMEM_OPTIN", text)
    assert f"W_MAX = {W_MAX} is the largest band" in text
