"""rustpotter's streaming detector, for a set of streams, in plain PyTorch.

`run_streams` takes each stream's 16 kHz PCM from its first chunk and
returns what the detector reports for every 30 ms chunk, as rustpotter v3's
`Rustpotter::process_samples` would (src/detector.rs:347-454), with these
settings: no VAD, no gain normalizer, no band-pass, MAX score mode.

Per shift of 160 samples the extractor's buffer takes the shift; from the
fourth shift after a reset every shift emits the frame of its last 480
samples, pushed into a window of F frames (F the longest template or NN
window). Once the window is full, the wakewords are scored on it:
  - a DTW wakeword compares each template of n frames, and its averaged
    template, with the window's first n frames less their mean (CMN), by
    banded DTW (`dtw.banded_dtw`); score = 1 / (1 + e^((c - ref) / ref)) of
    c = similarity / (2n); the wakeword's score is the templates' best, and
    it is a candidate where the averaged template's score reaches
    avg_threshold and the score passes threshold;
  - an NN wakeword runs its MLP (ReLU between layers) on the window's first
    train_size frames less their mean, flattened frame by frame; its score
    is 1 - 1 / (1 + e^(((p - none) - 10 ref) / (10 ref))) of the best logit
    p and the "none" logit; the candidate is its label (the last of equal
    best logits) when that is not "none", the score reaches threshold and
    the avg score (the same map of p and the least logit other than p)
    reaches avg_threshold.
The best candidate (highest score, the first on ties) feeds the partial
detection: a countdown of F / 2 frames restarts at every candidate, and
when it runs out a partial of min_scores candidates or more is reported
and the detector resets its window and extractor. A report ends the chunk
for that stream (the rest of its shifts are dropped).

The streams reach the detector BATCHED_CHUNK_LAG_SHIFTS shifts late: the
batched chunk of rustpotter_tpu (`make_batched_chunk`, in the JAX package and
its port alike) computes shift s's frame from the 480 samples that end at
shift s - 1, which is rustpotter's detector on the stream one shift (10 ms)
late. That is the batched path's timing in both packages, and the port is
held to the JAX package's batched events by the repository's tests; the
per-shift step (`make_step`) takes the samples that end at shift s, so its
timing is a delay of 0.

The window at a scored shift always holds the last F frames of the stream:
after a reset the extractor refills and the window is scored again only
once F new frames have been pushed. So the scores are computed for every
shift at once, then the bookkeeping runs shift by shift.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtw import banded_dtw
from .frontend import SHIFT, Frontend, stream_mfccs
from .products import dtype_of, matmul

FRAME_SAMPLES = 480
BATCHED_CHUNK_LAG_SHIFTS = 1  # the batched chunk's timing, see the docstring


@dataclass
class DtwWakeword:
    templates: Sequence[Tuple[str, np.ndarray]]  # (name, (n, C)), in name order
    avg: Optional[np.ndarray]  # (La, C)
    threshold: float
    avg_threshold: float


@dataclass
class NnWakeword:
    labels: Sequence[str]
    train_size: int
    layers: Sequence[Tuple[np.ndarray, np.ndarray]]  # (W (out, in), b (out,))


@dataclass
class Settings:
    threshold: float = 0.5
    avg_threshold: float = 0.2
    min_scores: int = 5
    eager: bool = False
    score_ref: float = 0.22
    band: int = 5


@dataclass
class Report:
    """What the detector reports per chunk, (S, N) each; the fields past
    `fired` are the reported detection's, read where fired is True."""

    fired: np.ndarray
    ww: np.ndarray
    score: np.ndarray
    avg_score: np.ndarray
    counter: np.ndarray
    scores: np.ndarray  # (S, N, smax)
    mfcc: np.ndarray  # (S, 3N, C): every shift's frame, the window's rows
    gates: np.ndarray  # (S, 3N, W): each wakeword's gate at every shift

    def window(self, chunks: int) -> np.ndarray:
        """(S, F, C): the window's rows once `chunks` chunks are heard, oldest
        first (rows before the stream's first shift are zeros)."""
        F = self.window_frames
        g = 3 * chunks
        rows = self.mfcc[:, max(0, g - F):g]
        pad = np.zeros((rows.shape[0], F - rows.shape[1], rows.shape[2]))
        return np.concatenate([pad, rows], axis=1)

    window_frames: int = 0


def window_frames(wakewords) -> int:
    F = 0
    for w in wakewords:
        F = max(F, max(len(t) for _, t in w.templates) if isinstance(w, DtwWakeword)
                else w.train_size)
    return F


def smax_of(wakewords) -> int:
    return max(len(w.templates) if isinstance(w, DtwWakeword) else len(w.labels)
               for w in wakewords)


def _score(cost: torch.Tensor, ref: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp((cost - ref) / ref))


def _windows(mfcc: torch.Tensor, F: int, g0: int, g1: int, n: int) -> torch.Tensor:
    """The first n frames of the F-frame windows ending at shifts g0 .. g1-1
    of every stream, less their mean: (S * (g1 - g0), n, C)."""
    S, _, C = mfcc.shape
    idx = torch.arange(g0 - F + 1, g1 - F + 1, device=mfcc.device)[:, None] \
        + torch.arange(n, device=mfcc.device)[None, :]
    win = mfcc[:, idx]  # (S, g1 - g0, n, C)
    win = win - win.mean(dim=2, keepdim=True)
    return win.reshape(-1, n, C)


def _dtw_candidates(w: DtwWakeword, mfcc, F, g0, g1, s: Settings, precision, smax):
    dt, dev = mfcc.dtype, mfcc.device
    t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    scores = []
    for _, tpl in w.templates:
        n = len(tpl)
        sims = banded_dtw(t(tpl), _windows(mfcc, F, g0, g1, n), s.band, precision)
        scores.append(_score(sims / (2 * n), s.score_ref))
    tscores = torch.stack(scores, dim=-1)  # (M, K)
    score = tscores.max(dim=-1).values
    gate_on = w.avg is not None and w.avg_threshold != 0.0
    if gate_on:
        n = len(w.avg)
        sims = banded_dtw(t(w.avg), _windows(mfcc, F, g0, g1, n), s.band, precision)
        avg = _score(sims / (2 * n), s.score_ref)
        passed = avg >= w.avg_threshold
    else:
        avg = torch.zeros_like(score)
        passed = torch.ones_like(score, dtype=torch.bool)
    det = passed & (score > w.threshold)
    padded = torch.nn.functional.pad(tscores, (0, smax - tscores.shape[-1]))
    return det, score, avg, padded, passed


def _nn_candidates(w: NnWakeword, mfcc, F, g0, g1, s: Settings, precision, smax):
    dt, dev = mfcc.dtype, mfcc.device
    x = _windows(mfcc, F, g0, g1, w.train_size)
    x = x.reshape(x.shape[0], -1)
    for i, (W, b) in enumerate(w.layers):
        x = matmul(x, torch.tensor(W, dtype=dt, device=dev).T, precision) \
            + torch.tensor(b, dtype=dt, device=dev)
        if i < len(w.layers) - 1:
            x = torch.relu(x)
    logits = x  # (M, labels)
    L = logits.shape[1]
    none = list(w.labels).index("none") if "none" in w.labels else -1
    label = L - 1 - torch.argmax(torch.flip(logits, (-1,)), dim=-1)
    best = logits.max(dim=-1).values
    none_p = logits[:, none] if none >= 0 else torch.zeros_like(best)
    ref = s.score_ref * 10.0
    inv = lambda a, b: 1.0 - 1.0 / (1.0 + torch.exp(((a - b) - ref) / ref))
    score = inv(best, none_p)
    others = logits != best[:, None]
    second = torch.where(others.any(dim=-1),
                         torch.where(others, logits, float("inf")).min(dim=-1).values,
                         torch.zeros_like(best))
    avg = inv(best, second) if s.avg_threshold != 0.0 else torch.zeros_like(best)
    det = (label != none) & (score >= s.threshold) & (avg >= s.avg_threshold)
    return det, score, avg, torch.nn.functional.pad(logits, (0, smax - L)), torch.ones_like(det)


def candidates(mfcc: torch.Tensor, wakewords, s: Settings, precision: str,
               block: int = 1 << 16):
    """Every shift's best candidate (numpy, (S, G) each; scores (S, G,
    smax)), and each wakeword's gate (S, G, W): whether its averaged
    template's score reached avg_threshold (always, for an NN wakeword);
    shifts before the first full window read as no candidate, gate shut."""
    S, G, _ = mfcc.shape
    F, smax = window_frames(wakewords), smax_of(wakewords)
    out = [np.zeros((S, G), bool), np.zeros((S, G), np.int64), np.zeros((S, G)),
           np.zeros((S, G)), np.zeros((S, G, smax)), np.zeros((S, G, len(wakewords)), bool)]
    step = max(1, block // S)
    for g0 in range(F - 1, G, step):
        g1 = min(G, g0 + step)
        cols = []
        for w in wakewords:
            f = _dtw_candidates if isinstance(w, DtwWakeword) else _nn_candidates
            cols.append(f(w, mfcc, F, g0, g1, s, precision, smax))
        det = torch.stack([c[0] for c in cols], dim=1)  # (M, W)
        score = torch.stack([c[1] for c in cols], dim=1)
        avg = torch.stack([c[2] for c in cols], dim=1)
        vec = torch.stack([c[3] for c in cols], dim=1)  # (M, W, smax)
        masked = torch.where(det, score, -float("inf"))
        best = torch.argmax(masked, dim=1)  # the first of equal scores
        pick = lambda a: a.gather(1, best[:, None]).squeeze(1)
        rows = [det.any(dim=1), best, pick(score), pick(avg),
                vec[torch.arange(vec.shape[0], device=vec.device), best],
                torch.stack([c[4] for c in cols], dim=1)]
        for o, r in zip(out, rows):
            o[:, g0:g1] = r.reshape(S, g1 - g0, *r.shape[1:]).cpu().numpy()
    return out


def bookkeeping(cands, F: int, n_chunks: int, s: Settings):
    """The detector's state machine over the shifts, per chunk (numpy)."""
    any_det, best, score, avg, vec = cands[:5]
    S = any_det.shape[0]
    ext = np.zeros(S, np.int64)
    win_count = np.zeros(S, np.int64)
    countdown = np.zeros(S, np.int64)
    active_p = np.zeros(S, bool)
    p_ww = np.zeros(S, np.int64)
    p_score = np.zeros(S)
    p_avg = np.zeros(S)
    p_counter = np.zeros(S, np.int64)
    p_vec = np.zeros((S, vec.shape[-1]))
    rep = dict(fired=np.zeros((S, n_chunks), bool), ww=np.zeros((S, n_chunks), np.int64),
               score=np.zeros((S, n_chunks)), avg_score=np.zeros((S, n_chunks)),
               counter=np.zeros((S, n_chunks), np.int64),
               scores=np.zeros((S, n_chunks, vec.shape[-1])))
    for t in range(n_chunks):
        halted = np.zeros(S, bool)
        for g in range(3 * t, 3 * t + 3):
            active = ~halted
            emit_frame = active & (ext >= FRAME_SAMPLES)
            ext = np.where(active, np.minimum(ext + SHIFT, FRAME_SAMPLES), ext)
            win_count = np.where(emit_frame, np.minimum(win_count + 1, F), win_count)
            run = emit_frame & (win_count >= F)
            countdown = np.where(run & (countdown != 0), countdown - 1, countdown)
            done = run & active_p & ((countdown == 0) | (s.eager & (p_counter >= s.min_scores)))
            emit = done & (p_counter >= s.min_scores)
            for k, v in (("ww", p_ww), ("score", p_score), ("avg_score", p_avg),
                         ("counter", p_counter), ("scores", p_vec)):
                rep[k][emit, t] = v[emit]
            rep["fired"][emit, t] = True
            active_p = active_p & ~done
            cand = run & ~emit & any_det[:, g]
            replace = cand & (~active_p | (p_score < score[:, g]))
            p_counter = np.where(cand, np.where(active_p, p_counter + 1, 1), p_counter)
            active_p = (active_p | cand) & ~emit
            p_ww = np.where(replace, best[:, g], p_ww)
            p_score = np.where(replace, score[:, g], p_score)
            p_avg = np.where(replace, avg[:, g], p_avg)
            p_vec = np.where(replace[:, None], vec[:, g], p_vec)
            countdown = np.where(cand, F // 2, countdown)
            win_count = np.where(emit, 0, win_count)
            ext = np.where(emit, 0, ext)
            halted = halted | emit
    return rep


def run_streams(pcm: torch.Tensor, wakewords, s: Settings, mfcc_size: int,
                precision: str, delay_shifts: int = BATCHED_CHUNK_LAG_SHIFTS) -> Report:
    """pcm (S, N * 480) on any device -> the Report of N chunks, the
    streams reaching the detector `delay_shifts` shifts late (that many
    shifts of silence in front, as many of their last samples not yet
    heard): the batched chunk's timing by default, 0 for the per-shift
    step's."""
    S, n = pcm.shape
    n_chunks = n // FRAME_SAMPLES
    if delay_shifts:
        lag = delay_shifts * SHIFT
        pcm = torch.cat([pcm.new_zeros((S, lag)), pcm[:, :n - lag]], dim=1)
    front = Frontend(mfcc_size, pcm.device, precision)
    mfcc = stream_mfccs(pcm.to(dtype_of(precision)), front)
    F = window_frames(wakewords)
    cands = candidates(mfcc, wakewords, s, precision)
    rep = bookkeeping(cands, F, n_chunks, s)
    return Report(mfcc=mfcc.cpu().numpy(), gates=cands[5], window_frames=F, **rep)
