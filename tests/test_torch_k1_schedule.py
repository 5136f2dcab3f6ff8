"""K1's schedule (csrc/fused_dtw_v4.cu) on the CPU: a numpy transcription of
the kernel's loop, held against the plain version `fused_dtw_chunk_v4_ref`.

The transcription follows the .cu step for step: the two launches (avg
pairs, then gated template pairs), a block of 32 lanes x 3 shift threads of
one pair, the walk over the extended sequence E in steps of two columns
(an odd n+w ends in a step whose second column lies past the last), E's
two tiles and the T' ring in shared memory with the copies of the next
step, the unguarded step before the barrier (clamped rows and columns, each
T' row dotted with both columns, predicated ring stores, band slots 0 and 1
of both DP steps read from the ring), the shared dot ring of R rows x 2w+2
diagonals, the register ring of rwn, the per-shift validity and harvest
rules, and the gate (__syncthreads_count over the block, __any_sync over a
shift's warp) with the gated launch's tracing counts, the four totals and
two per wakeword. The rings' sizes are the .cu's, compiled by the host
compiler. Rings and tiles start as NaN (the kernel's are uninitialized): a
valid cell that read a slot never written would turn its similarity into
NaN and fail the comparison. It runs in the worst order the one barrier per
step allows: the copies of step m+1 land before any thread reads step m's
tile or T' rows, every thread's stores of a step come before any thread's
reads of slots 0 and 1, and every thread's stores of step m+1 come before
any thread's DP of step m; so a ring or tile too short to hold a value
until its last read fails here, and a dot ring one row shorter than the
.cu's does. FLOPs are counted as the kernel executes them and held to
`utils.profiling.k1_executed`; the gate counts are held to the plain
version's with tracing on (`fused_dtw.k1_gate_counts`).

Tolerance: rtol 3e-6 / atol 2e-4 with an equal +inf pattern (the JAX kernel
tests'). The transcription rounds each product of a dot before adding it
where the kernel fuses them.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.utils import profiling, tracing
from test_torch_k3_schedule import _cu_constants

RTOL, ATOL = 3e-6, 2e-4
LANES, SHIFTS = 32, 3
LM, C, B = 12, 4, 3
D, K = 2, 2
P = D * K + D
LENS = (LM, 2, 1, 7) + (LM, 9)  # templates of ww0, ww1, then the avg pairs
BANDS = (2, 3, 5)


@lru_cache(maxsize=None)
def _cu():
    """The .cu's ring sizes at each band of BANDS, by the host compiler."""
    return _cu_constants(fd.SOURCE, ("RC", "U", "NR", "RT", "TROWS", "UNR", "LANES", "SHIFTS"),
                         BANDS, C)


def _dot(t, x):
    """One fp32 chain over c in order: t (C,), x (C, LANES)."""
    acc = t[0] * x[0]
    for c in range(1, len(t)):
        acc = (acc + t[c] * x[c]).astype(np.float32)
    return acc


def k1_schedule(win, newr, means, tpl, lens, gate, rot0, w, D, K, ring_columns=None):
    """The kernel's sims (3, P, B), the FLOPs it executed and the gated
    launch's counts (lanes open, lanes, blocks that work, blocks, then lanes
    open and blocks that work of each wakeword). `ring_columns` replaces the
    .cu's dot ring columns RC (the rwn ring keeps RC)."""
    F, Cn, Bn = win.shape
    P = D * K + D
    cu = _cu()[w]
    W2, U, NR, RT, RC = 2 * w, cu["U"], cu["NR"], cu["RT"], cu["RC"]
    RD = RC if ring_columns is None else ring_columns
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
        klast, kend = n + 1, n + w
        nsteps = -(-kend // 2)

        def ext(k):  # ext_column: column k of E
            nj = k - (F - 1)
            if nj >= 0:
                return newr[nj][:, bl]
            ph = rot + 1 + k
            return win[ph - F if ph >= F else ph][:, bl]

        tiles = np.full((2, 2, Cn, LANES), np.nan, np.float32)
        tring = np.full((RT + NR, Cn), np.nan, np.float32)  # NR rows mirrored after RT
        ring = np.full((RD, U, LANES), np.nan, np.float32)  # [column][diagonal][lane]
        rw = np.zeros((SHIFTS, RC, LANES), np.float32)
        prev = np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                         for j in range(W2)])
        prev = np.stack([prev] * SHIFTS)  # (3, 2w, LANES)
        clamp = lambda t: min(max(t, 0), n - 2)

        def stage(m_):  # step m_'s columns into its tile (every warp's rows)
            for col in range(2):
                tiles[m_ % 2, col] = ext(min(2 * m_ + col, klast))

        def stage_row(j, t):  # a T' row into ring row j, and its mirror
            tring[j] = tp(clamp(t))
            if j < NR:
                tring[RT + j] = tring[j]

        # step 0's T' window (rows -w-1 ... w+1 in ring rows 0 ... 2w+2) and tile
        for r_ in range(W2 + 3):
            stage_row(r_, r_ - w - 1)
        stage(0)

        def part_a(m_):
            """The step m_ before its barrier: the copies of step m_+1 land
            first; then every thread's unguarded work and ring stores; then
            every thread's reads of slots 0 and 1. Returns the threads'
            registers."""
            k = 2 * m_
            tk = k % RT
            if k + 2 < kend:
                stage(m_ + 1)
                for i in range(2):
                    stage_row((tk + RT - 2 + i) % RT, k + w + 2 + i)
            x = tiles[m_ % 2]  # (2, C, LANES)
            regs = []
            for s in range(SHIFTS):
                tdm = (tk + 2 - s) % RT
                dm = [_dot(tring[tdm + col], m[s]) for col in range(2)]
                rv = []
                for col in range(2):
                    acc = np.zeros(LANES, np.float32)
                    for c in range(Cn):
                        dd = x[col, c] - m[s, c]
                        acc = (acc + dd * dd).astype(np.float32)
                    kk = k + col
                    mine = (kk >= s) & (kk - s < n) & (acc != 0)
                    with np.errstate(divide="ignore"):
                        rv.append(np.where(mine, 1 / np.sqrt(acc), 0).astype(np.float32))
                trow = (tk + s * NR) % RT
                dv = {}
                for i in range(NR + 1):
                    row = tring[trow + i]
                    if i < NR:
                        dv[2 * i] = _dot(row, x[0])
                    if i > 0:
                        dv[2 * i - 1] = _dot(row, x[1])
                for e in range(2 * NR):  # unguarded, but for the dots past the 2U
                    i, col = (e + 1) // 2, e & 1
                    if s * 2 * NR + e < 2 * U:
                        ring[(k + col) % RD, U - 1 + col - (s * NR + i)] = dv[e]
                flops[0] += (2 * 2 * Cn + 2 * (3 * Cn + 1) + 2 * NR * 2 * Cn) * nlive
                regs.append([dm, rv])
            for s in range(SHIFTS):  # slots 0 and 1, after every thread's stores
                regs[s].append([[ring[(k + col - W2 + 1 + j) % RD, s + j].copy() for j in range(2)]
                                for col in range(2)])
            return regs

        def part_b(m_, regs):
            """Each shift thread's two DP steps of step m_, after the barrier."""
            k = 2 * m_
            for s, (dm, rv, hoisted) in enumerate(regs):
                for col in range(2):
                    rw[s, (k + col) % RC] = rv[col]
                for col in range(2):
                    kq = k + col
                    r = kq - w + 2 - s
                    if not (dp_warp[s] and 1 <= r <= n - 1):
                        continue
                    hi = min(n, r + w - 1)
                    cost = []
                    for j in range(W2):
                        cdp = r - w + j
                        kk = kq - W2 + 1 + j
                        dot = hoisted[col][j] if j < 2 else ring[kk % RD, s + j]
                        with np.errstate(invalid="ignore"):
                            c = 1 - (dot - dm[col]) * rw[s, kk % RC]
                        cost.append(c if 1 <= cdp <= hi else np.full(LANES, inf))
                    pv = prev[s]
                    cur = [cost[j] + np.minimum(pv[j + 1] if j + 1 < W2 else inf, pv[j])
                           for j in range(W2)]
                    for j in range(1, W2):
                        cur[j] = np.minimum(cur[j], cost[j] + cur[j - 1])
                    prev[s] = np.stack(cur)
                    flops[0] += (3 * W2 + 2 * W2 + 2 * (W2 - 1)) * nlive

        regs = part_a(0)
        for m_ in range(nsteps):
            # between barrier m and m+1 each thread takes the DP steps of step
            # m, then step m+1's work; run in the worst order for the ring:
            # every thread's stores of step m+1 before any thread's DP of step m
            later = part_a(m_ + 1) if m_ + 1 < nsteps else None
            part_b(m_, regs)
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


def _inputs(F, w, seed, lm=LM):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    tpl = rng.normal(0, 1, (P, lm, C)).astype(np.float32)
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


def _run(F, w, gate, ring_columns=None, lens=LENS):
    """(the transcription's sims (B, 3, P) and FLOPs, the plain version's
    sims) at window length F, band w, gate kind `gate` and pair lengths
    `lens` (templates of max(lens) rows)."""
    x = _inputs(F, w, seed=F * 10 + w, lm=max(lens))
    rot0 = torch.tensor(F - 2, dtype=torch.int32)  # the cursor wraps
    args = lambda g: (x["win"], x["new"], x["means3"], x["templates"], x["tnorms"], g, lens,
                      w, D, K, rot0)
    avg = fd.fused_dtw_chunk_v4_ref(*args(torch.full((D,), np.inf)))[:, :, D * K:]
    bounds = _gate(gate, avg)
    want = fd.fused_dtw_chunk_v4_ref(*args(bounds)).numpy()
    tset = fd.prepare_templates(x["templates"], x["tnorms"], lens, w)
    got, flops, _ = k1_schedule(x["win"].numpy(), x["new"].numpy(), x["means3"].numpy(),
                                tset.padded.numpy(), lens, bounds.numpy(), F - 2, w, D, K,
                                ring_columns)
    return got.transpose(2, 0, 1), flops, want  # (B, 3, P), the wrapper's view


def _assert_sims_close(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gate", ["open", "closed", "mixed"])
@pytest.mark.parametrize("w", BANDS)
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_schedule_matches_plain_version(F, w, gate):
    got, flops, want = _run(F, w, gate)
    _assert_sims_close(got, want)
    if gate == "open":
        assert flops == profiling.k1_executed(LENS, w, C, B)
    if gate == "closed":
        assert np.isinf(got[:, :, : D * K]).all() and flops == profiling.k1_executed(
            LENS[D * K:], w, C, B)


@pytest.mark.parametrize("w", BANDS)
def test_a_dot_ring_one_column_shorter_than_the_least_fails(w):
    """The .cu's dot ring has 2w+2 columns, as many as a group of its
    unrolled steps covers, so that its slots are compile-time. The least
    that holds each dot until its last read in the worst order is 2w+1
    columns, and the transcription gives the plain version's sims with it;
    with 2w they leave them (pairs of 30 rows and shorter, so that a dot of
    column k + 2w overwrites one that a valid cell still reads)."""
    assert _cu()[w]["RC"] == 2 * w + 2 and _cu()[w]["U"] == 2 * w + 2
    lens = (30, 25, 1, 7) + (30, 20)
    for columns in (2 * w + 2, 2 * w + 1):
        _assert_sims_close(*_run(32, w, "open", ring_columns=columns, lens=lens)[::2])
    with pytest.raises(AssertionError):
        _assert_sims_close(*_run(32, w, "open", ring_columns=2 * w, lens=lens)[::2])


@pytest.mark.parametrize("c", [4, 5, 8, 13, 16, 20])
def test_the_wide_copies_cover_each_piece_of_a_step_once(c):
    """The 16-byte copies (csrc/fused_dtw_v4.cu Stager, B % 4 == 0): thread t
    copies column t // HALF's pieces t % HALF + HALF i, i < CHT, piece j
    being coefficient j // 8 and streams 4 (j % 8) ... 4 (j % 8) + 3; over
    the block's 96 threads every piece of both columns is copied once."""
    cu = _cu_constants(fd.SOURCE, ("HALF", "CH", "CHT"), (5,), c)[5]
    half, ch, cht = cu["HALF"], cu["CH"], cu["CHT"]
    assert (half, ch) == (SHIFTS * LANES // 2, 8 * c) and half * cht >= ch
    pieces = [(t // half, j // 8, j % 8) for t in range(SHIFTS * LANES) for i in range(cht)
              for j in [t % half + half * i] if j < ch]
    assert sorted(pieces) == [(col, k, q) for col in range(2) for k in range(c) for q in range(8)]


def test_the_rings_follow_the_cu():
    """E's tiles, the T' ring with its mirror and the rwn ring as the
    transcription sizes them: 2w+5 T' rows and NR mirrored, w+1 unrolled
    steps covering the dot ring's 2w+2 columns, NR dots per column of a
    shift thread."""
    for w, c in _cu().items():
        assert (c["LANES"], c["SHIFTS"]) == (LANES, SHIFTS)
        assert c["NR"] == -(-(2 * w + 2) // 3) and c["RT"] == 2 * w + 5
        assert c["TROWS"] == c["RT"] + c["NR"] and 2 * c["UNR"] == c["RC"]
    for w in range(2, 21):
        nr = -(-(2 * w + 2) // 3)
        assert fd.k1_smem_bytes(w, C) == 4 * ((2 * w + 2) ** 2 * LANES + 4 * C * LANES
                                              + (2 * w + 5 + nr) * C)


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
    assert done == 4_123_262_976
