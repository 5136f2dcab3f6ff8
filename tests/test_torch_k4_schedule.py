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

The column form (W_MAX < w <= 75 at C = 16) is transcribed as the .cu runs
it: a block of S streams x up to 8 pair slots (tid = slot * S + stream;
streams past B copy stream B - 1), the first span (columns -w ... w+RS-2,
each slot holding window column clip(col, 0, Lm-1)) staged, waited for and
behind a barrier, every thread's rwn of it, then the steps of RS DP rows:
the next step's RS columns staged into the spare slots (counted
incrementally, wrapped by a compare), the step's T' rows and dotms, the
wavefront over the span (column i, then rows k in order at band slot i - k,
one in-place frontier of 2w, every cell computed and +inf by a select, the
similarity taken at row n - 1), the wait and the barrier, the rwn of the
new columns. The column ring and the rwn ring start as NaN and each slot
records the column it holds, which every read checks. Each step runs in the
worst order for the ring: the next step's copies, which the .cu issues
right after a step's barrier, land before any of the step's reads; one slot
short fails. Pairs are long enough (n > CF_SLOTS x RS) that a ring slot is
reused at every place of a step. FLOPs are held to
`utils.profiling.k4_column_executed`.

The row form (w past the column form's) is transcribed too: one thread per
(stream, pair) takes the DP rows in order, each cell with its clamped window
column.

It also pins the wrapper's mirror of the .cu (`k4_form`, `k4_column_plan`,
`k4_smem_bytes`, K4_W_MAX, K4_PRODUCERS) to the .cu constants, evaluated by
the host C++ compiler, on both sides of every change of form, of streams
per block and of rows per step.

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
LANES, MAX_JOBS = 32, 8
Q = fd.K4_PRODUCERS
W_MAX = fd.K4_W_MAX
ROW_FROM = 76  # the row form's first band at C = 16
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


def k4_column_schedule(win, means, tpl, lens, w, rows, streams, slots=None):
    """The column form's sims (P, B) and the FLOPs it executed: win (Lm, C,
    B), means (P, C, B), tpl the padded T' (P, w + Lm + w, C), `rows` DP rows
    per step, `streams` per block; `slots` replaces the 2w + 2RS - 1 ring
    slots. All the blocks of a block row run at once, as arrays (block,
    pair slot, stream)."""
    Lm, Cn, Bn = win.shape
    P = len(lens)
    W2 = 2 * w
    S = streams
    span = W2 + rows - 1
    SL = slots or span + rows
    jy = min(P, MAX_JOBS)
    NB = -(-Bn // S)
    inf = np.float32(np.inf)
    out = np.full((P, Bn), np.nan, np.float32)
    flops = [0]
    b = np.arange(NB)[:, None] * S + np.arange(S)[None, :]  # (NB, S)
    bl = np.minimum(b, Bn - 1)
    live_b = b < Bn

    def block_row(by):
        ps = [by * jy + ty for ty in range(jy)]
        ns = np.array([lens[p] if p < P else 0 for p in ps])
        live = live_b[None] & (np.array(ps) < P)[:, None, None]  # (jy, NB, S)
        nlive = lambda mask: int((live & mask[:, None, None]).sum())
        nmax = int(max(lens[p] for p in ps if p < P))
        pc = [min(p, P - 1) for p in ps]
        m = np.stack([means[q][:, bl] for q in pc], axis=1)  # (C, jy, NB, S)
        ring = np.full((SL, Cn, NB, S), np.nan, np.float32)
        held = np.full(SL, -10 ** 6)  # the window column each slot holds
        rwn = np.full((SL, jy, NB, S), np.nan, np.float32)
        rheld = np.full(SL, -10 ** 6)

        def stage(col, s):
            ring[s] = win[min(max(col, 0), Lm - 1)][:, bl]
            held[s] = col

        def read(s, col):
            if held[s] != col:
                raise AssertionError(f"ring slot {s} read for column {col} holds column {held[s]}")
            return ring[s]  # (C, NB, S): one column for every pair slot

        def make_rwn(s):
            x = ring[s]
            acc = np.zeros((jy, NB, S), np.float32)
            for c in range(Cn):
                d = x[c] - m[c]
                acc = (acc + d * d).astype(np.float32)
            with np.errstate(divide="ignore"):
                rwn[s] = np.where(acc != 0, 1 / np.sqrt(acc), 0).astype(np.float32)
            rheld[s] = held[s]
            flops[0] += (3 * Cn + 1) * nlive(np.ones(jy, bool))

        def dot(t, x):
            """One fp32 chain over c in order: t (jy, C), x (C, [jy,] NB, S)."""
            acc = t[:, 0, None, None] * x[0]
            for c in range(1, Cn):
                acc = (acc + t[:, c, None, None] * x[c]).astype(np.float32)
            return acc

        for s in range(span):
            stage(s - w, s)
        # the copies are waited for, then the barrier
        for s in range(span):
            make_rwn(s)
        F = [np.where(j == w, np.float32(0), inf) * np.ones((jy, NB, S), np.float32)
             for j in range(W2)]
        result = np.full((jy, NB, S), inf, np.float32)
        base = 0
        for r0 in range(1, nmax, rows):
            nxt = base + rows - (SL if base + rows >= SL else 0)
            more = r0 + rows < nmax
            if more:  # issued right after the barrier: before any of this step's reads
                for k in range(rows):
                    s = nxt + W2 - 1 + k
                    stage(r0 + rows + w - 2 + k, s - SL if s >= SL else s)
            act = r0 < ns  # (jy,): the pair slots with rows left
            if act.any():
                t = [np.stack([tpl[q, r0 - 1 + k + w] for q in pc]) for k in range(rows)]
                dotm = [dot(t[k], m) for k in range(rows)]
                flops[0] += rows * 2 * Cn * nlive(act)
                s = base
                for i in range(span):
                    col = r0 - w - 1 + i
                    x = read(s, col)
                    if rheld[s] != col:
                        raise AssertionError(f"rwn slot {s} read for column {col} holds "
                                             f"column {rheld[s]}")
                    rw = rwn[s]
                    for k in range(rows):
                        j = i - k
                        if j < 0 or j >= W2:
                            continue
                        cdp = r0 + k - w + j
                        cell = (1 - (dot(t[k], x) - dotm[k]) * rw).astype(np.float32)
                        valid = ((cdp >= 1) & (cdp <= ns))[:, None, None]
                        cost = np.where(valid, cell, inf)
                        ins = F[j + 1] if j + 1 < W2 else inf
                        v = cost + np.minimum(ins, F[j])
                        if j > 0:
                            v = np.minimum(v, cost + F[j - 1])
                        a3 = act[:, None, None]
                        F[j] = np.where(a3, v, F[j])
                        if j == w + 1:
                            result = np.where(a3 & (r0 + k == ns - 1)[:, None, None], v, result)
                        flops[0] += (2 * Cn + 3 + 2 + (2 if j > 0 else 0)) * nlive(act)
                    s = s + 1 - (SL if s + 1 >= SL else 0)
            # the copies are waited for, then the barrier; then the new columns' rwn
            if more:
                for k in range(rows):
                    s = nxt + W2 - 1 + k
                    make_rwn(s - SL if s >= SL else s)
            base = nxt
        for ty, p in enumerate(ps):
            if p < P:
                out[p] = result[ty].reshape(-1)[:Bn]

    for by in range(-(-P // jy)):
        block_row(by)
    return out, flops[0]


def _inputs(B, seed, lm=LM, lens=LENS):
    """win (B, Lm, C), means (B, P, C), raw templates and their squared row
    norms. Stream 0's window column 3 equals pair 0's mean, so its rwn is 0;
    template 1's first row is zero, and stays zero in T'."""
    rng = np.random.default_rng(seed)
    P = len(lens)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    win = rng.normal(0, 1, (B, lm, C)).astype(np.float32)
    means = rng.normal(0, 0.2, (B, P, C)).astype(np.float32)
    win[0, 3] = means[0, 0]
    tpl = rng.normal(0, 1, (P, lm, C)).astype(np.float32)
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


@pytest.mark.parametrize("w", [ROW_FROM, 96])
def test_row_form_matches_plain_version(w):
    """The row form, past the column form's limit (w = 75 at C = 16):
    columns clamped into 0 ... n-1, pairs of length 1 and 2, a zero-norm
    column; bands wider than the window."""
    assert fd.k4_form(w, 16) == "row"
    win, means, templates, tnorms = _inputs(35, seed=w)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, LENS, w).numpy()
    tset = fd.prepare_templates(templates, tnorms, LENS, w)
    win_t, means_t = (a.permute(1, 2, 0).contiguous().numpy() for a in (win, means))
    got = k4_row_schedule(win_t, means_t, tset.padded.numpy(), LENS, w).T
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _column_lens(w, rows):
    """A window long enough that a pair of it reuses every ring slot at
    every place of a step (n > CF_SLOTS x RS), and pairs of it: the longest,
    lengths 2 and 1, one a step short, half, 9."""
    lm = (2 * w + 2 * rows - 1) * rows + 2
    return lm, (lm, 2, 1, lm - 1, lm // 2, 9)


def _run_column(B, w, seed, lens=None, lm=None, rows=None, streams=None, slots=None):
    """The column schedule at (w, C = 4) with the C = 16 build's plan unless
    given, against the plain version; returns (got, want, flops, plan)."""
    plan_s, plan_rs = fd.k4_column_plan(w, 16)
    rows, streams = rows or plan_rs, streams or plan_s
    if lens is None:
        lm, lens = _column_lens(w, rows)
    win, means, templates, tnorms = _inputs(B, seed, lm, lens)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, lens, w).numpy()
    tset = fd.prepare_templates(templates, tnorms, lens, w)
    win_t, means_t = (a.permute(1, 2, 0).contiguous().numpy() for a in (win, means))
    got, flops = k4_column_schedule(win_t, means_t, tset.padded.numpy(), lens, w, rows,
                                    streams, slots)
    return got.T, want, flops, (lens, rows)


def _assert_matches(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


# the column form's bands at C = 16: its first (W_MAX + 1), F1's (21, 24),
# the first band of each change of rows per step or streams per block (34,
# 35, 36 at 32 streams; 37, 16 streams; 44, 52, 60, 68) and its last, K3's
# widest (75)
COLUMN_BANDS = (W_MAX + 1, 21, 24, 34, 35, 36, 37, 44, 52, 60, 68, ROW_FROM - 1)


@pytest.mark.parametrize("w", COLUMN_BANDS)
def test_column_form_matches_plain_version(w):
    """The committed plan at each band, B = 35 (a short last block): pairs
    of length 1 and 2, a zero-norm column, a zero template row; FLOPs as
    `k4_column_executed` counts them."""
    assert fd.k4_form(w, 16) == "column"
    got, want, flops, (lens, rows) = _run_column(35, w, seed=w)
    _assert_matches(got, want)
    assert np.isinf(got[:, 2]).all() and np.isfinite(want[:, [0, 1, 3, 4, 5]]).all()
    assert flops == profiling.k4_column_executed(lens, w, C, 35, rows)


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5])
def test_column_form_every_rows_per_step(rows):
    """The loop is generic in RS: each count of rows per step at w = 21, one
    stream (15 dead lanes of 16), pair lengths that end a step at every row
    of it."""
    lm = 60
    lens = (lm, 2, 1, 58, 57, 56, 55, 3)
    got, want, flops, _ = _run_column(1, 21, seed=rows, lens=lens, lm=lm, rows=rows)
    _assert_matches(got, want)
    assert flops == profiling.k4_column_executed(lens, 21, C, 1, rows)


@pytest.mark.parametrize("streams", [32, 16])
def test_column_form_eleven_pairs_take_a_second_block_row(streams):
    """P = 11: a second block row of 3 pairs beside 5 dead pair slots, at
    either count of streams per block."""
    lm = 60
    lens = tuple(lm - 5 * i for i in range(11))
    got, want, flops, (_, rows) = _run_column(33, 21, seed=11, lens=lens, lm=lm,
                                              streams=streams)
    _assert_matches(got, want)
    assert flops == profiling.k4_column_executed(lens, 21, C, 33, rows)


@pytest.mark.parametrize("w", [21, 75])
def test_column_ring_one_slot_short_fails_the_schedule(w):
    """The ring's bound is tight: with 2w + 2RS - 2 slots, the next step's
    copy, issued after a step's barrier, lands on a slot the step still
    reads."""
    rows = fd.k4_column_plan(w, 16)[1]
    with pytest.raises(AssertionError, match=r"ring slot \d+ read for column -?\d+ holds column"):
        _run_column(35, w, seed=7, slots=2 * w + 2 * rows - 2)


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


@pytest.mark.parametrize("w,need,done", [(21, 7_351_844_864, 8_333_180_928),
                                          (24, 8_225_079_296, 9_469_034_496)])
def test_column_executed_work_at_the_bench_shapes(w, need, done):
    """The column form's FLOPs at the bench shapes at F1's bands: no fewer
    than the function needs, and at most 16 % more (every cell of the 2w
    band computed, the last step's rows past n - 1, the rwn of the block's
    longest pair's columns)."""
    lens = (100, 98, 96, 94, 92, 100)
    rows = fd.k4_column_plan(w, 16)[1]
    assert 8192 * sum(profiling.dp_work(n, w, 16, True) for n in lens) == need
    assert profiling.k4_column_executed(lens, w, 16, 8192, rows) == done
    assert need <= done <= 1.16 * need


def test_k4_form_and_smem_follow_the_cu():
    """K4's form (RING_FORM, COLUMN_FORM, from RP_W and RP_C alone), the ring
    form's producer warps and ring rows, the column form's streams per
    block, rows per step and ring slots, and the shared memory, at every
    band from 2 to past the column form's limit, at C = 16 and 8; the row
    form takes the wider bands without shared memory, so K4's wrapper never
    refuses a band for it."""
    for C16, last in ((16, ROW_FROM - 1), (8, 91)):
        bands = range(2, last + 3)
        consts = _cu_constants("fused_dtw_v2.cu", (
            "RING_FORM", "COLUMN_FORM", "Q", "R", "W_MAX", "RING_BYTES", "SMEM_BYTES",
            "CF_STREAMS", "CF_RS", "CF_SPAN", "CF_SLOTS", "CF_BYTES", "CF_REGS"), bands, C16)
        for w in bands:
            c = consts[w]
            form = fd.k4_form(w, C16)
            assert (c["RING_FORM"], c["COLUMN_FORM"]) == (form == "ring", form == "column"), w
            assert (c["Q"], c["W_MAX"], c["R"]) == (Q, W_MAX, 2 * w + 2 * Q - 1), w
            assert c["CF_REGS"] == fd.K4_CF_REGS
            assert c["SMEM_BYTES"] == fd.k4_smem_bytes(w, C16), w
            assert (c["RING_BYTES"] <= _build.SMEM_OPTIN) == (w <= W_MAX), w
            if form == "column":
                streams, rows = fd.k4_column_plan(w, C16)
                assert (c["CF_STREAMS"], c["CF_RS"]) == (streams, rows), w
                assert (c["CF_SPAN"], c["CF_SLOTS"]) == (2 * w + rows - 1, 2 * w + 2 * rows - 1), w
                assert c["CF_BYTES"] == c["SMEM_BYTES"] <= _build.SMEM_OPTIN, w
            fd._check_smem("K4", fd.k4_smem_bytes(w, C16), w, C16)
        forms = [fd.k4_form(w, C16) for w in (W_MAX, W_MAX + 1, last, last + 1)]
        assert forms == ["ring", "column", "column", "row"], C16
    # at C = 16: 32 streams and 5 rows per step from w = 20, 4 from 34, 3 from
    # 35, 2 from 36; 16 streams and 5 rows from 37, 4 from 44, 3 from 52, 2
    # from 60, 1 from 68; the row form from 76
    bands = (20, 33, 34, 35, 36, 37, 43, 44, 51, 52, 59, 60, 67, 68, 75, 76)
    plan = {w: fd.k4_column_plan(w, 16) for w in bands}
    assert plan == {20: (32, 5), 33: (32, 5), 34: (32, 4), 35: (32, 3), 36: (32, 2),
                    37: (16, 5), 43: (16, 5), 44: (16, 4), 51: (16, 4), 52: (16, 3),
                    59: (16, 3), 60: (16, 2), 67: (16, 2), 68: (16, 1), 75: (16, 1), 76: None}
    assert fd.k4_smem_bytes(5, 16) == 23_936 and fd.k4_smem_bytes(21, 16) == 156_672
    assert fd.k4_smem_bytes(75, 16) == 231_936 and fd.k4_smem_bytes(ROW_FROM, 16) == 0
    text = (_build.CSRC / "fused_dtw_v2.cu").read_text()
    assert re.search(r"static_assert\(!RING_FORM \|\| RING_BYTES <= SMEM_OPTIN", text)
    assert re.search(r"static_assert\(!COLUMN_FORM \|\| CF_BYTES <= SMEM_OPTIN", text)
    assert f"W_MAX = {W_MAX} is the largest band" in text
    assert "w <= 75 at C = 16, 91 at\n// C = 8" in text
