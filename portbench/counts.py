"""The benchmark's yardstick of work: the FLOPs and bytes of one 30 ms chunk
of the batched detector, counted from shapes, and the card's peaks.

Copied from the program's `utils/profiling.py` (`ChipSpec`, `k1_work`,
`k1_bytes`, `bound`) so that a later change to the program cannot move it,
with one change: K1's template pairs are counted only where the inputs that
were run opened the averaged template's gate (`k1_flops`), since K1 skips a
stream's template pairs where that gate is closed.

A product's bytes count each operand read once and the result written once.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

# NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit): fp32 on
# the CUDA cores, outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

FRAME, BINS = 480, 240

Product = Tuple[str, float, float]  # (name, FLOPs, bytes)


def gemm(name: str, m: int, k: int, n: int) -> Product:
    """(m, k) @ (k, n) in fp32."""
    return name, 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)


def frontend_products(B: int, C: int) -> List[Product]:
    """The three shifts' MFCCs of B streams: the windowed DFT (cos and sin
    side by side), the mel bank and the DCT, over C + 1 coefficients."""
    n = C + 1
    return [gemm("dft", 3 * B, FRAME, 2 * BINS), gemm("mel", 3 * B, BINS, n),
            gemm("dct", 3 * B, n, n)]


def cmn_products(B: int, C: int, F: int, P: int) -> List[Product]:
    """The per-shift CMN means of the P template pairs: masks over the
    window's F rows and over the chunk's 3 new rows, against (C * B)."""
    return [gemm("cmn_window", 3 * P, F, C * B), gemm("cmn_new", 3 * P, 3, C * B)]


def nn_products(B: int, C: int, F: int, train_size: int, sizes: List[int]) -> List[Product]:
    """An NN wakeword of layer sizes [train_size * C, h1, ..., labels] on
    the chunk's three shifts: the first layer against the window (3 h1, F C)
    @ (F C, B); the new rows' corrections, one (h1, C) @ (C, B) per new row
    inside the first train_size frames of each shift's window; the new rows'
    CMN mean (3, 3) @ (3, C B) and its product with the summed weights
    (h1, C) @ (C, 3B); the later layers on the 3B columns."""
    h1 = sizes[1]
    out = [gemm("nn_layer1", 3 * h1, F * C, B)]
    corrections = sum(1 for s in range(3) for j in range(s + 1) if F - (s + 1) + j < train_size)
    out += [gemm("nn_correction", h1, C, B)] * corrections
    out += [gemm("nn_mean_new", 3, 3, C * B), gemm("nn_mean_fold", h1, C, 3 * B)]
    out += [gemm(f"nn_layer{i + 2}", b, a, 3 * B) for i, (a, b) in enumerate(zip(sizes[1:-1], sizes[2:]))]
    return out


def _k1_pair(n: int, w: int, C: int, shifts: Tuple[int, ...]) -> float:
    """FLOPs K1 needs for one stream and pair of length n scored at the
    given shifts of the chunk, counted as the program's `k1_work` counts
    them: rwn over n columns (sub + FMA per coefficient, one rsqrt), and per
    DP row r < n the dotm chain (2C), the mean correction of every valid band
    cell (sub, mul, 1 -) and the DP (add + min per slot, then the add + min
    chain), per scored shift; the dots T'[r-1].W[c] once per distinct
    window column over the scored shifts (2C each)."""
    k = len(shifts)
    if not k:
        return 0.0
    flops = k * n * (3 * C + 1)
    for r in range(1, n):
        cols = [r - w + j for j in range(2 * w) if 1 <= r - w + j <= min(n, r + w - 1)]
        flops += 2 * C * len({c + s for c in cols for s in shifts})
        flops += k * (2 * C + 3 * len(cols) + 2 * (2 * w) + 2 * (2 * w - 1))
    return float(flops)


def k1_flops(template_lens: Iterable[int], avg_len: int, w: int, C: int, B: int,
             patterns: Dict[Tuple[int, ...], float]) -> float:
    """K1's FLOPs for a chunk of B streams of one DTW wakeword: the averaged
    template's pair at every shift of every stream, and the template pairs
    at the shifts whose gate opened. `patterns` maps each set of open
    shifts (a sorted tuple) to the number of streams with that set."""
    flops = B * _k1_pair(avg_len, w, C, (0, 1, 2))
    for shifts, streams in patterns.items():
        flops += streams * sum(_k1_pair(n, w, C, shifts) for n in template_lens)
    return flops


def k1_bytes(F: int, C: int, B: int, P: int, Lm: int) -> float:
    """K1's bytes, each read or written once: window, new rows, means, T'
    and its (P, Lm) row norms, and the sims."""
    return 4.0 * (F * C * B + 3 * C * B + 3 * P * C * B + P * Lm * C + P * Lm + B * 3 * P)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time at the data-sheet peaks."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def gate_patterns(gates, B_of_class: Dict[str, int], classes) -> Dict[Tuple[int, ...], float]:
    """Streams per set of open shifts, scaled to the fleet: `gates` (S, N, 3)
    bool, the sampled streams' gate decisions over N chunks; `classes` (S,)
    each sampled stream's class; `B_of_class` how many of the fleet's
    streams are of each class. Each class's sampled chunks stand for that
    class's streams in a chunk."""
    out: Counter = Counter()
    for cls, B in B_of_class.items():
        rows = [g for g, c in zip(gates, classes) if c == cls]
        chunks = [tuple(int(s) for s in range(3) if row[t, s])
                  for row in rows for t in range(row.shape[0])]
        if not chunks:
            continue
        for shifts, n in Counter(chunks).items():
            out[shifts] += B * n / len(chunks)
    return dict(out)
