"""K5's schedule (csrc/fused_dtw_v1.cu) on the CPU: a numpy transcription of
the kernel's row loop, held against the plain version `fused_dtw_batch_ref`.

The transcription follows the .cu step for step: a block of 32 lanes x up to
8 pair-warps (a second block row past 8 pairs, dead warps past P), the
prologue (columns -w ... w-2 into slots 0 ... 2w-2, each slot holding window
column clip(col, 0, Lm-1)), its barrier and rwn, then the steps of RS DP rows:
the step's RS new columns into the slots counted incrementally from the
base slot (wrapped by a compare), the barrier, each thread's rwn of the new
columns into its own entry of the rwn ring, its RS T' rows and dotms, the
branch-free band step (every dot of the SPAN = 2w + RS - 1 ring columns,
+inf by a select where the cell is invalid) and the RS DP steps, the last
ones skipped past the pair's length. The rings start as NaN, and each slot
records the column it holds, which every read checks: a slot read before it
is written, or after another column overwrote it, fails. Each step runs in
the worst order for the ring: every warp's writes of step u+1 before any
warp's reads of step u (they run between the same two barriers), so a ring
too short to hold a column until its last read fails here too (one slot
short fails, whatever RS). Pairs are long enough (n >= SLOTS x RS at every
tested band) that a ring slot is reused at every place of a step.

It also pins the wrapper's mirror of the .cu (`k5_rows_per_step`,
`k5_smem_bytes`) to the .cu constants, evaluated by the host C++ compiler,
at every band up to one past the limit.

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
from test_torch_k3_schedule import _cu_constants

RTOL, ATOL = 3e-6, 1e-4
LANES, MAX_JOBS = 32, 8
# pairs of n = 1 and 2, and pairs long enough that every ring slot is reused
# at every place of a step at every tested band (SLOTS x RS <= 135 rows)
LM, C = 136, 4
LENS = (LM, 2, 1, 135, 50, 9)


def _dot(t, x):
    """One fp32 chain over c in order: t (C,), x (C, LANES)."""
    acc = t[0] * x[0]
    for c in range(1, len(t)):
        acc = (acc + t[c] * x[c]).astype(np.float32)
    return acc


def k5_schedule(win, means, tpl, lens, w, rows, slots=None):
    """The kernel's sims (P, B): win (Lm, C, B), means (P, C, B), tpl the
    padded T' (P, w + Lm + w, C), `rows` DP rows per step; `slots` replaces
    the kernel's 2w + 2RS - 1 ring slots."""
    Lm, Cn, Bn = win.shape
    P = len(lens)
    W2 = 2 * w
    span = W2 + rows - 1
    S = slots or span + rows
    jy = min(P, MAX_JOBS)
    inf = np.float32(np.inf)
    out = np.full((P, Bn), np.nan, np.float32)

    def block(bx, by):
        lane = np.arange(LANES)
        b = bx * LANES + lane
        live_b = b < Bn
        bl = np.where(live_b, b, 0)
        ps = [by * jy + ty for ty in range(jy)]
        ns = [lens[p] if p < P else 0 for p in ps]
        nmax = max(ns)
        ring = np.full((S, Cn, LANES), np.nan, np.float32)
        held = np.full(S, -10 ** 6)  # the window column each slot holds
        rwn = np.full((S, jy, LANES), np.nan, np.float32)
        rheld = np.full((S, jy), -10 ** 6)
        ms = [np.where(live_b & (p < P), means[min(p, P - 1)][:, bl], 0).astype(np.float32)
              for p in ps]

        def load(col, s):
            src = min(max(col, 0), Lm - 1)
            ring[s] = np.where(live_b, win[src][:, bl], 0)
            held[s] = col

        def read(s, col):
            if held[s] != col:
                raise AssertionError(f"ring slot {s} read for column {col} holds column {held[s]}")
            return ring[s]

        def make_rwn(s):
            for ty in range(jy):
                x = ring[s]
                acc = np.zeros(LANES, np.float32)
                for c in range(Cn):
                    d = x[c] - ms[ty][c]
                    acc = (acc + d * d).astype(np.float32)
                with np.errstate(divide="ignore"):
                    rwn[s, ty] = np.where(acc == 0, 0, 1 / np.sqrt(acc)).astype(np.float32)
                rheld[s, ty] = held[s]

        prev = [np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                          for j in range(W2)]) for _ in range(jy)]
        result = [np.full(LANES, inf) for _ in range(jy)]

        def new_columns(r0, base):
            """A step's writes: columns r0+w-2 ... into slots base+2w-1 ..."""
            for k in range(rows):
                s = base + W2 - 1 + k
                load(r0 + w - 2 + k, s - S if s >= S else s)

        def step(r0, base):
            """A step after its barrier: rwn of the new columns, then each
            pair-warp's band step and DP rows."""
            for k in range(rows):
                s = base + W2 - 1 + k
                make_rwn(s - S if s >= S else s)
            for ty in range(jy):
                n, p = ns[ty], min(ps[ty], P - 1)
                if r0 >= n:
                    continue
                t = [tpl[p, r0 - 1 + k + w] for k in range(rows)]
                dotm = [_dot(t[k], ms[ty]) for k in range(rows)]
                cost = [[None] * W2 for _ in range(rows)]
                s = base
                for i in range(span):
                    col = r0 - w - 1 + i
                    x = read(s, col)
                    if rheld[s, ty] != col:
                        raise AssertionError(f"rwn slot {s} read for column {col} holds "
                                             f"column {rheld[s, ty]}")
                    for k in range(rows):
                        j = i - k
                        if 0 <= j < W2:
                            cdp = r0 + k - w + j
                            cell = (1 - (_dot(t[k], x) - dotm[k]) * rwn[s, ty]).astype(np.float32)
                            cost[k][j] = cell if 1 <= cdp <= n else np.full(LANES, inf)
                    s = s + 1 - (S if s + 1 >= S else 0)
                for k in range(rows):
                    if k > 0 and r0 + k >= n:
                        break
                    pv = prev[ty]
                    cur = [cost[k][j] + np.minimum(pv[j + 1] if j + 1 < W2 else inf, pv[j])
                           for j in range(W2)]
                    for j in range(1, W2):
                        cur[j] = np.minimum(cur[j], cost[k][j] + cur[j - 1])
                    prev[ty] = np.stack(cur)
                    if r0 + k == n - 1:
                        result[ty] = cur[w + 1]

        for s in range(W2 - 1):
            load(s - w, s)
        # after the prologue's barrier: its rwn races with the first step's
        # writes; after barrier u, step u's reads with step u+1's writes
        steps = list(range(1, nmax, rows))
        bases = [(rows * u) % S for u in range(len(steps))]
        if steps:
            new_columns(steps[0], bases[0])
        for s in range(W2 - 1):
            make_rwn(s)
        for u, (r0, base) in enumerate(zip(steps, bases)):
            if u + 1 < len(steps):
                new_columns(steps[u + 1], bases[u + 1])
            step(r0, base)
        for ty, p in enumerate(ps):
            if p < P:
                out[p, b[live_b]] = result[ty][live_b]

    for by in range(-(-P // jy)):
        for bx in range(-(-Bn // LANES)):
            block(bx, by)
    return out


def _inputs(B, seed, lens=LENS):
    """win (B, Lm, C), means (B, P, C), raw templates and their squared row
    norms. Stream 0's window column 3 equals pair 0's mean, so its rwn is 0;
    template 1's first row is zero, and stays zero in T'."""
    rng = np.random.default_rng(seed)
    P = len(lens)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    win = rng.normal(0, 1, (B, LM, C)).astype(np.float32)
    means = rng.normal(0, 0.2, (B, P, C)).astype(np.float32)
    win[0, 3] = means[0, 0]
    tpl = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    tpl[1, 0] = 0.0
    return t(win), t(means), t(tpl), t(np.sum(tpl ** 2, axis=-1))


def _run(win, means, templates, tnorms, lens, w, rows, slots=None):
    tset = fd.prepare_templates(templates, tnorms, lens, w)
    win_t, means_t = (a.permute(1, 2, 0).contiguous().numpy() for a in (win, means))
    return k5_schedule(win_t, means_t, tset.padded.numpy(), lens, w, rows, slots).T


def _assert_matches(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", [35, 1])  # a short second block; 31 dead lanes
@pytest.mark.parametrize("w", [2, 5, 9, 19, 20, 37])
def test_schedule_matches_plain_version(w, B):
    """The committed schedule (RS rows per step, from the band) at C = 4:
    ragged lengths 1 and 2, a zero-norm column, a zero template row."""
    rows = fd.k5_rows_per_step(w, 16)
    assert rows * (2 * w + 2 * rows - 1) <= max(LENS) - 1
    win, means, templates, tnorms = _inputs(B, seed=10 * w + B)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, LENS, w).numpy()
    got = _run(win, means, templates, tnorms, LENS, w, rows)
    _assert_matches(got, want)
    assert np.isinf(got[:, 2]).all() and np.isfinite(want[:, [0, 1, 3, 4, 5]]).all()


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_every_rows_per_step_matches_plain_version(rows):
    """The loop is generic in RS: each count of rows per step, with pair
    lengths that end a step at every row of it."""
    w = 5
    lens = (LM, 2, 1, 98, 97, 96, 95, 3)
    win, means, templates, tnorms = _inputs(33, seed=rows, lens=lens)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, lens, w).numpy()
    _assert_matches(_run(win, means, templates, tnorms, lens, w, rows), want)


def test_eleven_pairs_take_a_second_block_row():
    """P = 11: a second block row of 3 pairs beside 5 dead warps."""
    w = 5
    lens = tuple(LM - 7 * i for i in range(11))
    win, means, templates, tnorms = _inputs(33, seed=11, lens=lens)
    want = fd.fused_dtw_batch_ref(win, means, templates, tnorms, lens, w).numpy()
    got = _run(win, means, templates, tnorms, lens, w, fd.k5_rows_per_step(w, 16))
    _assert_matches(got, want)


@pytest.mark.parametrize("rows", [1, 2])
def test_ring_one_slot_short_fails_the_schedule(rows):
    """The ring's bound is tight: with 2w + 2RS - 2 slots, a fast warp's
    write of the next step's column lands on a slot a slow warp still reads."""
    w = 5
    win, means, templates, tnorms = _inputs(35, seed=7)
    with pytest.raises(AssertionError, match=r"ring slot \d+ read for column -?\d+ holds column"):
        _run(win, means, templates, tnorms, LENS, w, rows, slots=2 * w + 2 * rows - 2)


@pytest.mark.parametrize("C", [16, 8])
def test_k5_rows_and_smem_follow_the_cu(C):
    """RS (3, but 2 at 6 <= w <= 12 and w > 28, and fewer where that ring
    would pass the opt-in), the ring slots and the shared memory, pinned to
    the .cu at every band up to one past the limit; the band limit stays
    where the parent's was: w = 37 at C = 16, 56 at C = 8, past which the
    wrapper raises."""
    limit = {16: 37, 8: 56}[C]
    bands = range(2, limit + 2)
    consts = _cu_constants("fused_dtw_v1.cu", ("RS", "SPAN", "SLOTS", "SMEM_BYTES"), bands, C)
    for w in bands:
        c = consts[w]
        rows = fd.k5_rows_per_step(w, C)
        assert c["RS"] == rows, w
        assert (c["SPAN"], c["SLOTS"]) == (2 * w + rows - 1, 2 * w + 2 * rows - 1), w
        assert c["SMEM_BYTES"] == fd.k5_smem_bytes(w, C), w
        assert (fd.k5_smem_bytes(w, C) <= _build.SMEM_OPTIN) == (w <= limit), w
    got = [fd.k5_rows_per_step(w, C) for w in (2, 5, 6, 12, 13, 28, 29)]
    assert got == [3, 3, 2, 2, 3, 3, 2]
    assert [fd.k5_rows_per_step(w, C) for w in (limit - 1, limit)] == \
        {16: [2, 1], 8: [2, 1]}[C]
    fd._check_smem("K5", fd.k5_smem_bytes(limit, C), limit, C)
    with pytest.raises(ValueError, match="shared memory"):
        fd._check_smem("K5", fd.k5_smem_bytes(limit + 1, C), limit + 1, C)
    text = (_build.CSRC / "fused_dtw_v1.cu").read_text()
    assert re.search(r"static_assert\(SMEM_BYTES <= SMEM_OPTIN", text)
