"""K2's schedule (csrc/fused_dtw_v3.cu) on the CPU: a numpy transcription of
the kernel's loop, held against the plain version `fused_dtw_batch_v3_ref`.

The transcription follows the .cu step for step: the two launches (avg
pairs, then gated template pairs), a block of 32 lanes x (Q producer warps +
the DP warp) of one pair, the rounds of Q columns, each producer's
unguarded column step (its column and dotm rows loaded a round ahead and
clamped, rwn, 2w costs of clamped rows, predicated ring stores at the
incrementally counted ring row), the shared cost ring of 2w+2Q-1 rows x 2w
band slots, the DP warp's Q DP steps per round and its harvest, and the gate
(__syncthreads_or over the block). Rings start as NaN: a valid cell that
read a slot never written would turn its similarity into NaN and fail the
comparison; and each ring slot records the template row whose cost it
holds, which every valid cell's read checks. Between two barriers the DP
warp takes the rows of round u while the producers already run round u+1;
this runs in the worst order for the ring, every producer's writes of round
u+1 before the DP warp's reads of round u, so a ring too short to hold a row
until its read fails here too (2w+2Q-2 rows fail it). FLOPs are counted as
the kernel executes them and held to `utils.profiling.k2_executed`.

Tolerance: rtol 3e-6 / atol 2e-4 with an equal +inf pattern (the JAX kernel
tests'). The transcription rounds each product of a dot before adding it
where the kernel fuses them, and takes 1/sqrt where the kernel takes rsqrtf.
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.utils import profiling

RTOL, ATOL = 3e-6, 2e-4
LANES = 32
W_MAX = 20  # the largest band K2 takes on the card (csrc/fused_dtw_v3.cu W_MAX)
# two blocks of streams, the second with 3 live lanes; pairs long enough
# that a ring row is reused at every place in a round (n >= 3w + 3Q + 1 at
# w = 5)
LM, C, B = 36, 4, 35
D, K = 2, 2
P = D * K + D
LENS = (LM, 2, 1, 29) + (LM, 9)  # templates of ww0, ww1, then the avg pairs


def _dot(t, x):
    """One fp32 chain over c in order: t (C,), x (C, LANES)."""
    acc = t[0] * x[0]
    for c in range(1, len(t)):
        acc = (acc + t[c] * x[c]).astype(np.float32)
    return acc


def k2_schedule(win, means, dotm, tpl, lens, gate, rot, w, D, K, ring_rows=None):
    """The kernel's sims (P, B) and the FLOPs it executed; `ring_rows`
    replaces the kernel's 2w+2Q-1 rows of the cost ring."""
    F, Cn, Bn = win.shape
    P = D * K + D
    W2, Q = 2 * w, fd.k2_producers(w)
    R = ring_rows or W2 + 2 * Q - 1
    out = np.full((P, Bn), np.nan, np.float32)
    flops = [0]
    inf = np.float32(np.inf)

    def block(by, p, gated):
        lane = np.arange(LANES)
        b = by * LANES + lane
        live = b < Bn
        bl = np.where(live, b, Bn - 1)
        n = lens[p]
        opn = live
        if gated:
            d = p // K
            with np.errstate(invalid="ignore"):
                opn = live & (out[D * K + d, bl] <= gate[d])  # NaN closes
        if n < 2 or not opn.any():  # __syncthreads_or
            out[p, b[live]] = inf
            return
        nlive = int(live.sum())
        m = means[p][:, bl]  # (C, LANES)
        tp = lambda t: tpl[p, t + w]
        dmr = lambda t: dotm[p, min(max(t, 0), n - 2)][bl]

        def column(i):
            ph = rot + 1 + i
            return win[ph - F if ph >= F else ph][:, bl]

        ring = np.full((R * W2, LANES), np.nan, np.float32)
        held = np.full(R * W2, -1)  # the template row whose cost each slot holds
        kend = n + w - 2
        rounds = -(-kend // Q)
        # each producer's registers: column k, its next column and dotm rows
        # (loaded a round ahead) and its ring row of template row k + w
        prod = []
        for g in range(1, Q + 1):
            k = g - 1
            prod.append(dict(k=k, nxt=column(min(k, n - 1)),
                             dmn=[dmr(k + w - j) for j in range(W2)], base=(k + w) % R))

        def produce():
            """Every producer's round: column k whole, stores predicated."""
            for st in prod:
                k = st["k"]
                if k < kend:
                    x, dm = st["nxt"], st["dmn"]
                    st["nxt"] = column(min(k + Q, n - 1))
                    st["dmn"] = [dmr(k + Q + w - j) for j in range(W2)]
                    acc = np.zeros(LANES, np.float32)
                    for c in range(Cn):
                        dd = x[c] - m[c]
                        acc = (acc + dd * dd).astype(np.float32)
                    with np.errstate(divide="ignore"):
                        rw = np.where((k < n) & (acc != 0), 1 / np.sqrt(acc), 0).astype(np.float32)
                    for j in range(W2):
                        t = k + w - j
                        cost = 1 - (_dot(tp(min(max(t, 0), n - 2)), x) - dm[j]) * rw
                        row = st["base"] - j + (R if st["base"] - j < 0 else 0)
                        if 0 <= t <= n - 2:
                            ring[row * W2 + j] = cost
                            held[row * W2 + j] = t
                    flops[0] += (3 * Cn + 1 + W2 * (2 * Cn + 3)) * nlive
                st["k"] = k + Q
                st["base"] = st["base"] + Q - (R if st["base"] + Q >= R else 0)

        dp = dict(t=-w + 1, row=R - w + 1,
                  prev=np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                                 for j in range(W2)]))

        def take_rows():
            """The DP warp's Q rows of a round, after its barrier."""
            for _ in range(Q):
                t, row = dp["t"], dp["row"]
                dp["t"], dp["row"] = t + 1, 0 if row + 1 == R else row + 1
                if t < 0 or t > n - 2:
                    continue
                assert row == t % R
                r = t + 1
                hi = min(n, r + w - 1)
                cost = []
                for j in range(W2):
                    cdp = r - w + j
                    valid = 1 <= cdp <= hi
                    if valid and held[row * W2 + j] != t:
                        raise AssertionError(f"ring slot {row * W2 + j} read for row {t} holds "
                                             f"row {held[row * W2 + j]}")
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
        out[p, b[live]] = np.where(opn, dp["prev"][w + 1], inf)[live]

    def launch(pair0, npairs, gated):
        for by in range(-(-Bn // LANES)):
            for bx in range(npairs):
                block(by, pair0 + bx, gated)

    launch(D * K, D, False)
    if D * K:
        launch(0, D * K, True)
    return out, flops[0]


def _inputs(F, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    tpl = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    tpl[1, 0] = 0.0  # a zero template row stays zero in T'
    return dict(win=t(rng.normal(0, 1, (F, C, B))), means=t(rng.normal(0, 0.2, (P, C, B))),
                templates=t(tpl), tnorms=t(np.sum(tpl ** 2, axis=-1)))


def _gate(kind, avg):
    """Gate bounds (D,): every gate open, every one closed, or ww0's bound
    between two of its avg sims (ww1 open). avg is (B, D)."""
    if kind == "open":
        return torch.full((D,), np.inf)
    if kind == "closed":
        return avg.min(dim=0).values - 1.0
    v = avg[:, 0].sort().values
    i = v.numel() // 2
    return torch.stack([(v[i - 1] + v[i]) / 2, torch.tensor(np.inf)])


@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
@pytest.mark.parametrize("w", [2, 5, W_MAX])
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_schedule_matches_plain_version(F, w, gate):
    x = _inputs(F, seed=F * 100 + w)
    rot = torch.tensor(F - 2, dtype=torch.int32)  # the cursor wraps
    args = lambda g: (x["win"], x["means"], x["templates"], x["tnorms"], g, LENS, w, D, K, rot)
    avg = fd.fused_dtw_batch_v3_ref(*args(torch.full((D,), np.inf)))[:, D * K:]
    bounds = _gate(gate, avg)
    want = fd.fused_dtw_batch_v3_ref(*args(bounds)).numpy()
    tset = fd.prepare_templates(x["templates"], x["tnorms"], LENS, w)
    # dotm as score_shift computes it for the kernel
    dotm = torch.einsum("plc,pcb->plb", tset.tp, x["means"]).numpy()
    got, flops = k2_schedule(x["win"].numpy(), x["means"].numpy(), dotm, tset.padded.numpy(),
                             LENS, bounds.numpy(), F - 2, w, D, K)
    got = got.T  # (B, P), the wrapper's view
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    if gate == "open":
        assert flops == profiling.k2_executed(LENS, w, C, B)
    if gate == "closed":
        assert np.isinf(got[:, : D * K]).all() and flops == profiling.k2_executed(
            LENS[D * K:], w, C, B)
    if gate == "mixed":
        passing = (avg[:, 0] <= bounds[0]).numpy()
        np.testing.assert_array_equal(np.isfinite(got[:, 0]), passing)
        assert 0 < passing.sum() < B


def test_ring_one_row_short_fails_the_schedule():
    """The ring's bound is tight: with 2w+2Q-2 rows a producer's store of
    round u+1 lands on a slot the DP warp still reads in round u (band slot
    0 of a row t whose last column t + w - 1 opens its round)."""
    F, w = LM + 2, 5
    x = _inputs(F, seed=7)
    gate = torch.full((D,), np.inf)
    tset = fd.prepare_templates(x["templates"], x["tnorms"], LENS, w)
    dotm = torch.einsum("plc,pcb->plb", tset.tp, x["means"]).numpy()
    with pytest.raises(AssertionError, match=r"ring slot \d+ read for row \d+ holds row"):
        k2_schedule(x["win"].numpy(), x["means"].numpy(), dotm, tset.padded.numpy(), LENS,
                    gate.numpy(), F - 2, w, D, K,
                    ring_rows=2 * w + 2 * fd.k2_producers(w) - 2)


def test_executed_work_at_the_bench_shapes():
    """The design's FLOPs per shift at the bench shapes, gate open: no fewer
    than the function needs (2.0211 GFLOP), and at most 6 % more."""
    lens = (100, 98, 96, 94, 92, 100)
    need = 8192 * sum(profiling.dp_work(n, 5, 16, False) for n in lens)
    done = profiling.k2_executed(lens, 5, 16, 8192)
    assert need == 2_021_146_624
    assert need <= done <= 1.06 * need
    assert done == 2_133_311_488
