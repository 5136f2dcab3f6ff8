"""K1's schedule (csrc/fused_dtw_v4.cu) on the CPU: a numpy transcription of
the kernel's loop, held against the plain version `fused_dtw_chunk_v4_ref`.

The transcription follows the .cu step for step: the two launches (avg
pairs, then gated template pairs), a block of 32 lanes x 3 shift threads of
one pair, the walk over the extended sequence E, the unguarded column step
(clamped rows and columns, predicated ring stores), the shared dot ring of
2w+1 rows x 2w+2 diagonals, the register ring of rwn, the per-shift
validity and harvest rules, and the gate (__syncthreads_count over the
block, __any_sync over a shift's warp) with the gated launch's tracing
counts, the four totals and two per wakeword. Rings start as NaN (the kernel's zeros): a
valid cell that read a slot never written would turn its similarity into
NaN and fail the comparison. Between two barriers a thread takes the DP
step of column k, then the step of column k+1; this runs in the worst order
for the ring, every thread's writes of column k+1 before any thread's reads
of column k, so a ring too short to hold a row until its last read fails
here too. FLOPs are counted as the kernel executes them
and held to `utils.profiling.k1_executed`; the gate counts are held to the
plain version's with tracing on (`fused_dtw.k1_gate_counts`).

Tolerance: rtol 3e-6 / atol 2e-4 with an equal +inf pattern (the JAX kernel
tests'). The transcription rounds each product of a dot before adding it
where the kernel fuses them.
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.utils import profiling, tracing

RTOL, ATOL = 3e-6, 2e-4
LANES, SHIFTS = 32, 3
LM, C, B = 12, 4, 3
D, K = 2, 2
P = D * K + D
LENS = (LM, 2, 1, 7) + (LM, 9)  # templates of ww0, ww1, then the avg pairs


def _dot(t, x):
    """One fp32 chain over c in order: t (C,), x (C, LANES)."""
    acc = t[0] * x[0]
    for c in range(1, len(t)):
        acc = (acc + t[c] * x[c]).astype(np.float32)
    return acc


def k1_schedule(win, newr, means, tpl, lens, gate, rot0, w, D, K):
    """The kernel's sims (3, P, B), the FLOPs it executed and the gated
    launch's counts (lanes open, lanes, blocks that work, blocks, then lanes
    open and blocks that work of each wakeword)."""
    F, Cn, Bn = win.shape
    P = D * K + D
    W2, U, R = 2 * w, 2 * w + 2, 2 * w + 1
    NR = (U + SHIFTS - 1) // SHIFTS
    out = np.full((3, P, Bn), np.nan, np.float32)
    flops = [0]
    counts = [0] * (4 + 2 * D)
    inf = np.float32(np.inf)

    def block(bx, p, gated):
        lane = np.arange(LANES)
        b = bx * LANES + lane
        live = b < Bn
        bl = np.where(live, b, Bn - 1)
        n = lens[p]
        opn = np.stack([live] * SHIFTS)  # (3, LANES)
        if gated:
            d = p // K
            with np.errstate(invalid="ignore"):
                opn = live & (out[:, D * K + d, bl] <= gate[d])  # NaN closes
        nopen = int(opn.sum())  # __syncthreads_count
        if gated:  # thread (0, 0)'s atomics: four, then two at its wakeword's slots
            works = int(n >= 2 and nopen > 0)
            for i, v in enumerate((nopen, SHIFTS * int(live.sum()), works, 1)):
                counts[i] += v
            counts[4 + 2 * d] += nopen
            counts[5 + 2 * d] += works
        if n < 2 or nopen == 0:
            out[:, p, b[live]] = inf
            return
        dp_warp = opn.any(axis=1)  # __any_sync over each shift's warp
        nlive = int(live.sum())
        m = means[:, p][:, :, bl]  # (3, C, LANES)
        tp = lambda t: tpl[p, t + w]
        rot = rot0 + 1 if rot0 + 1 < F else rot0 + 1 - F

        def ext(k):  # ext_column: column k of E
            nj = k - (F - 1)
            if nj >= 0:
                return newr[nj][:, bl]
            ph = rot + 1 + k
            return win[ph - F if ph >= F else ph][:, bl]

        rw = np.full((SHIFTS, W2, LANES), np.nan, np.float32)
        prev = np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                         for j in range(W2)])
        prev = np.stack([prev] * SHIFTS)  # (3, 2w, LANES)
        ring = np.full((R * U, LANES), np.nan, np.float32)
        klast, kend = n + 1, n + w

        def part_a(k):
            """Each shift thread's column step k before the barrier, with no
            guard: dotm of the row its DP completes at column k (clamped
            into [0, n-2]), rwn_s(k) and its NR dots (clamped rows); only the
            ring stores are predicated. Returns the threads' registers."""
            regs = []
            x = ext(min(k, klast))  # loaded during step k-1, clamped to klast
            for s in range(SHIFTS):
                t = k - w + 1 - s
                step = dp_warp[s] and 0 <= t <= n - 2
                dm = _dot(tp(min(max(t, 0), n - 2)), m[s])
                acc = np.zeros(LANES, np.float32)
                for c in range(Cn):
                    dd = x[c] - m[s, c]
                    acc = (acc + dd * dd).astype(np.float32)
                mine = (k >= s) & (k - s < n) & (acc != 0)
                with np.errstate(divide="ignore"):
                    rv = np.where(mine, 1 / np.sqrt(acc), 0).astype(np.float32)
                dv = [_dot(tp(min(max(k - w - 1 + s * NR + i, 0), n - 2)), x)
                      for i in range(NR)]
                for i in range(NR):
                    idx = s * NR + i
                    tr = k - w - 1 + idx
                    if idx < U and 0 <= tr <= n - 2 and k <= klast:
                        ring[(tr % R) * U + (U - 1 - idx)] = dv[i]
                flops[0] += (2 * Cn + 3 * Cn + 1 + NR * 2 * Cn) * nlive
                regs.append((step, dm, rv))
            return regs

        def part_b(k, regs):
            """Each shift thread's DP step of column k, after the barrier."""
            q = k % W2
            for s, (step, dm, _) in enumerate(regs):
                if not step:
                    continue
                t = k - w + 1 - s
                r = t + 1
                hi = min(n, r + w - 1)
                base = (t % R) * U + s
                cost = []
                for j in range(W2):
                    cdp = r - w + j
                    with np.errstate(invalid="ignore"):
                        c = 1 - (ring[base + j] - dm) * rw[s, (q + 1 + j) % W2]
                    cost.append(c if 1 <= cdp <= hi else np.full(LANES, inf))
                pv = prev[s]
                cur = [cost[j] + np.minimum(pv[j + 1] if j + 1 < W2 else inf, pv[j])
                       for j in range(W2)]
                for j in range(1, W2):
                    cur[j] = np.minimum(cur[j], cost[j] + cur[j - 1])
                prev[s] = np.stack(cur)
                flops[0] += (3 * W2 + 2 * W2 + 2 * (W2 - 1)) * nlive

        def keep(k, regs):  # a thread's own rwn ring, in program order
            for s, (_, _, rv) in enumerate(regs):
                rw[s, k % W2] = rv

        regs = part_a(0)
        keep(0, regs)
        for k in range(kend):
            # between barrier k and k+1 each thread takes the DP step of
            # column k, then the step of column k+1; run in the worst order
            # for the ring: every thread's writes of column k+1 before any
            # thread's reads of column k
            later = part_a(k + 1) if k + 1 < kend else None
            part_b(k, regs)
            if later is not None:
                keep(k + 1, later)
                regs = later
        for s in range(SHIFTS):
            out[s, p, b[live]] = np.where(opn[s], prev[s, w + 1], inf)[live]

    def launch(pair0, npairs, gated):
        for bx in range((Bn + LANES - 1) // LANES):
            for by in range(npairs):
                block(bx, pair0 + by, gated)

    launch(D * K, D, False)
    if D * K:
        launch(0, D * K, True)
    return out, flops[0], tuple(counts)


def _inputs(F, w, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    tpl = rng.normal(0, 1, (P, LM, C)).astype(np.float32)
    tpl[1, 0] = 0.0  # a zero template row stays zero in T'
    return dict(win=t(rng.normal(0, 1, (F, C, B))), new=t(rng.normal(0, 1, (3, C, B))),
                means3=t(rng.normal(0, 0.2, (3, P, C, B))), templates=t(tpl),
                tnorms=t(np.sum(tpl ** 2, axis=-1)))


def _gate(kind, avg):
    """Gate bounds (D,): every gate open, every one closed, or ww0's bound
    between two of its avg sims (ww1 open)."""
    if kind == "open":
        return torch.full((D,), np.inf)
    if kind == "closed":
        return avg.reshape(-1, D).min(dim=0).values - 1.0
    v = avg[..., 0].flatten().sort().values
    i = v.numel() // 2
    return torch.stack([(v[i - 1] + v[i]) / 2, torch.tensor(np.inf)])


@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
@pytest.mark.parametrize("w", [2, 3, 5])
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_schedule_matches_plain_version(F, w, gate):
    x = _inputs(F, w, seed=F * 10 + w)
    rot0 = torch.tensor(F - 2, dtype=torch.int32)  # the cursor wraps
    args = lambda g: (x["win"], x["new"], x["means3"], x["templates"], x["tnorms"], g, LENS,
                      w, D, K, rot0)
    avg = fd.fused_dtw_chunk_v4_ref(*args(torch.full((D,), np.inf)))[:, :, D * K:]
    bounds = _gate(gate, avg)
    want = fd.fused_dtw_chunk_v4_ref(*args(bounds)).numpy()
    tset = fd.prepare_templates(x["templates"], x["tnorms"], LENS, w)
    got, flops, _ = k1_schedule(x["win"].numpy(), x["new"].numpy(), x["means3"].numpy(),
                             tset.padded.numpy(), LENS, bounds.numpy(), F - 2, w, D, K)
    got = got.transpose(2, 0, 1)  # (B, 3, P), the wrapper's view
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    if gate == "open":
        assert flops == profiling.k1_executed(LENS, w, C, B)
    if gate == "closed":
        assert np.isinf(got[:, :, : D * K]).all() and flops == profiling.k1_executed(
            LENS[D * K:], w, C, B)


@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
def test_schedule_counts_the_gate_as_the_plain_version(gate):
    """The gated launch's counts, as the kernel adds them, equal what the
    plain version counts with tracing on, the four totals and each
    wakeword's two (one block per pair here; the pair of length 1 never
    works)."""
    F, w = LM + 2, 3
    x = _inputs(F, w, seed=7)
    rot0 = torch.tensor(F - 2, dtype=torch.int32)
    args = lambda g: (x["win"], x["new"], x["means3"], x["templates"], x["tnorms"], g, LENS,
                      w, D, K, rot0)
    bounds = _gate(gate, fd.fused_dtw_chunk_v4_ref(*args(torch.full((D,), np.inf)))[:, :, D * K:])
    tset = fd.prepare_templates(x["templates"], x["tnorms"], LENS, w)
    _, _, counts = k1_schedule(x["win"].numpy(), x["new"].numpy(), x["means3"].numpy(),
                               tset.padded.numpy(), LENS, bounds.numpy(), F - 2, w, D, K)
    tracing.reset()
    tracing.enable()
    try:
        fd.fused_dtw_chunk_v4_ref(*args(bounds))
        got = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    names = tracing.DEVICE_COUNTERS + sum((tracing.k1_wakeword_names(d) for d in range(D)), ())
    assert tuple(got[k] for k in names) == counts
    assert sum(counts[4::2]) == counts[0] and sum(counts[5::2]) == counts[2]
    counts = counts[:4]
    lanes = 3 * D * K * B
    assert counts[1:] == (lanes, {"open": 3, "closed": 0, "mixed": 3}[gate], D * K)
    assert counts[0] == {"open": lanes, "closed": 0}.get(gate, counts[0])
    assert gate != "mixed" or lanes / 2 <= counts[0] < lanes  # ww0 half open, ww1 open


def test_executed_work_is_within_the_target_at_the_bench_shapes():
    """The design's FLOPs per chunk at the bench shapes, gate open: at most
    4.5 GFLOP, and no fewer than the function needs."""
    lens = (100, 98, 96, 94, 92, 100)
    dots, rest = profiling.k1_work(lens, 5, 16, 8192)
    done = profiling.k1_executed(lens, 5, 16, 8192)
    assert dots + rest <= done <= 4.5e9
    assert done == 4_092_444_672
