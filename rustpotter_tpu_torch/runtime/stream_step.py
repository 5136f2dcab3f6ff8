"""The stream steps: B streams × one 30 ms chunk in → states' + Events.

Two counterparts of `rustpotter_tpu.runtime.stream_step`: the per-shift step
`make_step` (one shift at a time, as the reference runs; the single-stream
`Rustpotter` runs it at B = 1) and the batched serving chunk
`make_batched_chunk`. Both are the reference's streaming hot loop (reference
src/detector.rs:347-454 — process_audio → process_new_mfccs → run_detection) with every data-dependent
branch a masked update over the stream axis, for one 30 ms chunk (3 MFCC
shifts) at a time. The per-shift step writes each shift's row into the
circular window and scores it (`_dtw_scores`: K2, K4, or band costs then K3,
as `dtw_fused` and its variant select). The batched chunk hoists the work
out of the shift loop:
  - the extractor buffer trajectory is data-independent within a chunk (the
    reference consumes all 480 samples before the find_map short circuit,
    detector.rs:372-375), so the 3 frames' MFCCs are one batched GEMM chain;
  - the 3 per-shift windows differ from the pre-chunk window only in the
    newest rows, so scoring runs against VIRTUAL windows (window + the new
    rows): the CMN means read the window once per chunk and K1
    (ops/fused_dtw.py) scores all 3 shifts in one call;
  - only (B,)-vector bookkeeping (extractor fill count, VAD, win_count,
    countdown/partial/emit, the in-chunk halt) runs per shift;
  - the 3 rows are written into the circular window after every read.

Virtual-window validity: scores are consumed only where `run` holds, which
requires win_count >= F; a stream whose row write is masked off this chunk
(extractor warm-up or an in-chunk halt) has win_count reset alongside, so its
virtual-window scores are discarded.

With `dtw_fused` False or a variant below 3, the batched chunk scores each
shift's virtual window through `_dtw_scores` instead of K1, as the JAX
package's fallback does.

NN wakewords (`_nn_scores_one` per shift, `_nn_scores_chunk` per chunk) are
fp32 GEMMs and elementwise work, as in the JAX package, which has no Pallas
kernel there: the first layer's weights are rotated into the window's
physical frame order by an index on the device, so neither step reads the
cursor on the host. The best candidate is chosen over the DTW wakewords
first, then the NN ones (`_combine_batched`).

Both steps start with `filter_chunk`, the audio front-end of the JAX
package's `prepare_chunk`: the in-graph resampler (one fp32 GEMM,
`audio.resampler`) where the bundle takes chunks at another rate, and where a
filter is on the rms level, the gain normalizer (a rolling-rms window per
stream, summed in index order, the gain in steps of `ops.biquad.GAIN_STEP`)
and the band-pass biquad, both in `ops.biquad.front` (on the card one launch
per chunk of the hand-written kernel). The per-shift step then takes the rms
and the pre-emphasis (`prepare_chunk`); the batched chunk takes them, the
extractor buffer and the packed frames in `ops.frontend.prologue` (on the
card one launch of csrc/mfcc_front.cu), and its MFCCs in the window's
layout from `mfcc_from_frames`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..audio.resampler import make_torch_resampler
from ..config import ScoreMode
from ..constants import SAMPLES_PER_FRAME, SAMPLES_PER_SHIFT
from ..ops import biquad, frontend
from ..ops.dtw import band_costs
from ..ops.dtw_dispatch import get_banded_dtw
from ..ops.fused_dtw import (
    TemplateSet,
    linear_window,
    prepare_templates,
    score_chunk,
    score_linear,
    score_shift,
)
from ..ops.scoring import cost_to_score, nn_inverse_similarity
from ..wakewords.nn import forward_tail
from .bundle import StepParams, StepStatic
from .state import Event, StreamState, VAD_VOICE_FRAMES

INF = float("inf")

# optimal compare-exchange networks (Bose-Nelson/Batcher) for tiny K: the
# same exchanges as the JAX package, so percentile modes see the same order
_SORT_NETWORKS = {
    1: [],
    2: [(0, 1)],
    3: [(0, 1), (0, 2), (1, 2)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    5: [(0, 1), (3, 4), (2, 4), (2, 3), (1, 4), (0, 3), (0, 2), (1, 3), (1, 2)],
    6: [(1, 2), (4, 5), (0, 2), (3, 5), (0, 1), (3, 4), (2, 5), (0, 3), (1, 4),
        (2, 4), (1, 3), (2, 3)],
    7: [(1, 2), (3, 4), (5, 6), (0, 2), (3, 5), (4, 6), (0, 1), (4, 5), (2, 6),
        (0, 4), (1, 5), (0, 3), (2, 5), (1, 3), (2, 4), (2, 3)],
    8: [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2),
        (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6), (2, 4), (3, 5),
        (3, 4)],
}

_PERCENTILES = {
    ScoreMode.MEDIAN: 50.0, ScoreMode.P50: 50.0, ScoreMode.P25: 25.0,
    ScoreMode.P75: 75.0, ScoreMode.P80: 80.0, ScoreMode.P90: 90.0,
    ScoreMode.P95: 95.0,
}


def sort_last_axis(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along the last axis; compare-exchange network for K≤8."""
    pairs = _SORT_NETWORKS.get(x.shape[-1])
    if pairs is None:
        return torch.sort(x, dim=-1).values
    cols = list(x.unbind(-1))
    for a, b in pairs:
        cols[a], cols[b] = torch.minimum(cols[a], cols[b]), torch.maximum(cols[a], cols[b])
    return torch.stack(cols, dim=-1)


# ------------------------------------------------------------------ scoring

def _avg_gate_bounds(static: StepStatic, params: StepParams,
                     a_lens: torch.Tensor) -> torch.Tensor:
    """Sim-domain avg-gate bounds for K1, (D,).

    score(sim) >= th ⟺ sim <= 2·La·ref·(1 + ln(1/th − 1)) (the logistic
    cost_to_score is monotone ↓ in sim). A small relative margin keeps the
    kernel's skip conservative vs the f32 score-domain comparison in
    _dtw_post, which stays authoritative per stream. +inf disables the gate
    (no avg template, or avg_threshold == 0). The margin constants are the
    JAX package's, kept verbatim."""
    gon = params.dtw_has_avg & (params.dtw_avg_threshold != 0.0)
    tcl = torch.clamp(params.dtw_avg_threshold, 1e-6, 1.0 - 1e-6)
    bnd = (
        2.0 * a_lens.to(torch.float32) * static.score_ref
        * (1.0 + torch.log(1.0 / tcl - 1.0))
    )
    return torch.where(gon, bnd + torch.abs(bnd) * 1e-4 + 1e-4, INF)


def _reduce_mode(scores: torch.Tensor, kvalid: torch.Tensor, mode: ScoreMode) -> torch.Tensor:
    """Score-mode reduction over the (possibly padded) template axis.
    scores: (..., D, K); kvalid: (D,) actual template counts."""
    K = scores.shape[-1]
    ks = torch.arange(K, device=scores.device)
    valid = ks[None, :] < kvalid[:, None]  # (D, K)
    if mode == ScoreMode.AVERAGE:
        return torch.sum(torch.where(valid, scores, 0.0), dim=-1) / kvalid.to(torch.float32)
    if mode == ScoreMode.MAX:
        return torch.amax(torch.where(valid, scores, -INF), dim=-1)
    pct = _PERCENTILES[mode]
    s = sort_last_axis(torch.where(valid, scores, INF))
    index = torch.tensor(pct, dtype=torch.float32) / 100.0 * (kvalid.to(torch.float32) - 1.0)
    ifloor = torch.floor(index)
    i = ifloor.to(torch.int64)
    d = index - ifloor
    lo = torch.sum(torch.where(ks == i[:, None], s, 0.0), dim=-1)
    hi_i = torch.minimum(i + 1, kvalid.to(torch.int64) - 1)
    hi = torch.sum(torch.where(ks == hi_i[:, None], s, 0.0), dim=-1)
    return torch.where(ifloor == index, lo, lo * (1.0 - d) + hi * d)


def _dtw_post(static: StepStatic, params: StepParams, sims_all: torch.Tensor):
    """Per-stream scoring from the (B, P) pair similarities. Parity:
    wakeword_comp.rs:77-152 — avg-template gate as a mask, score-mode
    reduction, strict `score > threshold`. Returns (detected (B, D),
    score (B, D), avg_score (B, D), scores_mat (B, D, smax))."""
    D, K = static.n_dtw, static.kmax
    B = sims_all.shape[0]
    t_lens = params.dtw_lens
    a_lens = params.dtw_avg_len
    sims = sims_all[:, : D * K].reshape(B, D, K)
    a_sims = sims_all[:, D * K:]
    tscores = cost_to_score(sims / (2.0 * t_lens.to(torch.float32)), static.score_ref)
    score = _reduce_mode(tscores, params.dtw_kvalid, static.score_mode)

    # averaged-template gate (wakeword_comp.rs:85-94): branch → mask
    avg_score_raw = cost_to_score(a_sims / (2.0 * a_lens.to(torch.float32)), static.score_ref)
    gate_on = params.dtw_has_avg & (params.dtw_avg_threshold != 0.0)
    avg_score = torch.where(gate_on, avg_score_raw, 0.0)
    gate_pass = torch.where(gate_on, avg_score_raw >= params.dtw_avg_threshold, True)

    detected = gate_pass & (score > params.dtw_threshold)
    scores_mat = torch.nn.functional.pad(tscores, (0, static.smax - K))
    return detected, score, avg_score, scores_mat


def _chunk_slot_masks(F: int, t_all: torch.Tensor, rot0: torch.Tensor):
    """Coverage masks for per-shift masked means over the VIRTUAL windows.

    Returns (maskA (3, P, F) f32, maskB (3, P, 3) f32): for shift s
    (0-based; ns = s+1 new rows), maskA selects the pre-chunk window rows
    whose logical index at rot_s is < t and which are NOT superseded by a
    new row; maskB selects new row j (landing at logical F - ns + j) when
    covered. mean_s = (maskA·win + maskB·new) / t."""
    dev = t_all.device
    idx = torch.arange(F, device=dev)
    ns = torch.arange(1, 4, device=dev)  # (3,)
    rot = rot0.long()
    rot_s = (rot + ns) % F
    lidx = (idx[None, :] - rot_s[:, None] - 1) % F  # (3, F)
    covered = lidx[:, None, :] < t_all[None, :, None]  # (3, P, F)
    jn = torch.arange(3, device=dev)
    slots = (rot + 1 + jn) % F  # (3,)
    # slot jn (written at shift jn+1, 1-based ns) is superseded at ns >= jn+1
    superseded = torch.any(
        (idx[None, None, :] == slots[None, :, None])
        & (ns[:, None, None] >= (jn + 1)[None, :, None]),
        dim=1,
    )  # (3, F)
    maskA = (covered & ~superseded[:, None, :]).to(torch.float32)
    lnew = F - ns[:, None] + jn[None, :]  # (3, 3) logical index of new row j
    maskB = (
        (jn[None, None, :] < ns[:, None, None])
        & (lnew[:, None, :] < t_all[None, :, None])
    ).to(torch.float32)
    return maskA, maskB


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))


class NNConstants(NamedTuple):
    """One NN wakeword's first layer, laid out for the stream steps."""

    w1f: torch.Tensor  # (h1, ts, C) first-layer weights by logical frame
    w1p: torch.Tensor  # (h1, F, C) the same, zero rows beyond train_size
    wsum: torch.Tensor  # (h1, C) the sum over frames: folds the CMN mean


class ChunkConstants(NamedTuple):
    """What scoring needs from a parameter set and nothing else: built once
    per StepParams by `chunk_constants`, not per chunk or shift. The DTW
    fields are None in a bundle without DTW wakewords."""

    seq_a: Optional[torch.Tensor]  # (P, Lm, C) raw templates, then the avg templates
    tset: Optional[TemplateSet]  # the kernels' T' (P, Lm, C), padded copy and pair lengths
    t_all: Optional[torch.Tensor]  # (P,) pair lengths: CMN coverage of each pair
    inv_t: Optional[torch.Tensor]  # (1, P, 1) f32: 1/t, folded into the mean masks
    gate_bounds: Optional[torch.Tensor]  # (D,) sim-domain avg-gate bounds
    nn: Tuple[NNConstants, ...] = ()  # per NN wakeword


def _nn_constants(static: StepStatic, params: StepParams) -> Tuple[NNConstants, ...]:
    F, C = static.max_mfcc_frames, static.mfcc_size
    out = []
    for meta, layers in zip(static.nn_meta, params.nn_params):
        w1 = layers[0][0]
        w1f = w1.reshape(w1.shape[0], meta.train_size, C)
        out.append(NNConstants(
            w1f=w1f,
            w1p=torch.nn.functional.pad(w1f, (0, 0, 0, F - meta.train_size)),
            wsum=torch.sum(w1f, dim=1),
        ))
    return tuple(out)


def chunk_constants(static: StepStatic, params: StepParams) -> ChunkConstants:
    nn = _nn_constants(static, params)
    if not static.n_dtw:
        return ChunkConstants(None, None, None, None, None, nn)
    D, K, L = static.n_dtw, static.kmax, static.lmax
    Lm = max(L, static.la_max)
    C = static.mfcc_size
    seq_a = torch.cat([
        _pad_rows(params.dtw_templates.reshape(D * K, L, C), Lm),
        _pad_rows(params.dtw_avg, Lm),
    ])  # (P, Lm, C)
    tnorms = torch.sum(seq_a * seq_a, dim=-1)
    t_all = torch.cat([params.dtw_lens.reshape(-1), params.dtw_avg_len])
    return ChunkConstants(
        seq_a=seq_a,
        tset=prepare_templates(seq_a, tnorms, static.dtw_pair_lens, static.band_size),
        t_all=t_all,
        inv_t=(1.0 / t_all.to(torch.float32))[None, :, None],
        gate_bounds=_avg_gate_bounds(static, params, params.dtw_avg_len).contiguous(),
        nn=nn,
    )


def _fused_v3(static: StepStatic) -> bool:
    """True for the fused variant-3 kernels (K1 in the chunk, K2 per shift):
    dtw_fused None means fused here, on every device."""
    return static.dtw_fused is not False and static.dtw_fused_variant >= 3


def _dtw_scores(static: StepStatic, params: StepParams, consts: ChunkConstants,
                win: torch.Tensor, rot: torch.Tensor):
    """Score the live circular window (F, C, B) of every stream against every
    DTW wakeword; rot = physical index of the newest frame (logical frame i
    lives at (rot + 1 + i) % F). Returns the _dtw_post tuple batched on
    streams. Parity: wakeword_comp.rs:77-152, as `rustpotter_tpu`'s
    `_dtw_scores`: per-pair CMN means over the pair's first t logical frames
    (a masked fp32 GEMM), then K2 (fused, variant >= 3), K4 (fused, variant
    2: on the linear window, gathered outside the kernel as jnp.roll does),
    or band costs then K3 (not fused)."""
    F = win.shape[0]
    w = static.band_size
    Lm = consts.seq_a.shape[1]
    lidx = (torch.arange(F, device=win.device) - rot.long() - 1) % F  # logical index
    tmask = (lidx[None, :] < consts.t_all[:, None]).to(torch.float32)  # (P, F)
    means_t = (
        torch.einsum("pf,fcb->pcb", tmask, win)
        / consts.t_all.to(torch.float32)[:, None, None]
    )  # (P, C, B)
    if _fused_v3(static):
        sims = score_shift(win, means_t, consts.tset, consts.gate_bounds,
                           static.n_dtw, static.kmax, rot)
    elif static.dtw_fused is not False:
        sims = score_linear(linear_window(win, rot, Lm), means_t, consts.tset)
    else:
        lin = linear_window(win, rot, Lm).permute(2, 0, 1)  # (B, Lm, C)
        B, P = lin.shape[0], consts.seq_a.shape[0]
        normwin = lin[:, None] - means_t.permute(2, 0, 1)[:, :, None]  # (B, P, Lm, C)
        costs = band_costs(consts.seq_a, normwin, w).reshape(B * P, Lm, 2 * w)
        sims = get_banded_dtw(w)(costs, consts.t_all.repeat(B)).reshape(B, P)
    return _dtw_post(static, params, sims)


def _dtw_scores_chunk(static: StepStatic, params: StepParams, consts: ChunkConstants,
                      win: torch.Tensor, new: torch.Tensor, rot0: torch.Tensor):
    """DTW det_outs for all 3 shifts of a chunk. win (F, C, B) = PRE-chunk
    stream-minor circular window; new (3, C, B) = the chunk's new frames.
    Fused (variant >= 3): per-shift CMN means come from one masked GEMM
    over the window (+ a tiny one over the new rows), then K1 scores every
    (stream, shift, pair). Otherwise each shift's virtual window is
    materialized and scored by `_dtw_scores`, as the JAX fallback does.
    Returns a list of 3 _dtw_post tuples batched on streams."""
    if not _fused_v3(static):
        virt = win.clone()
        slots = (rot0.long() + 1 + torch.arange(3, device=win.device)) % win.shape[0]
        outs = []
        for s in range(3):
            virt.index_copy_(0, slots[s:s + 1], new[s:s + 1])
            outs.append(_dtw_scores(static, params, consts, virt, slots[s]))
        return outs
    maskA, maskB = _chunk_slot_masks(win.shape[0], consts.t_all, rot0)
    means3 = (
        torch.einsum("spf,fcb->spcb", maskA * consts.inv_t, win)
        + torch.einsum("spj,jcb->spcb", maskB * consts.inv_t, new)
    ).contiguous()  # (3, P, C, B)
    sims3 = score_chunk(
        win, new, means3, consts.tset, consts.gate_bounds,
        static.n_dtw, static.kmax, rot0,
    )  # (B, 3, P)
    return [_dtw_post(static, params, sims3[:, s]) for s in range(3)]


def _nn_post(static: StepStatic, params: StepParams, logits: torch.Tensor, j: int):
    """Per-stream NN label/score logic from the logits (B, labels). Parity:
    wakeword_nn.rs:47-124,161-163, as the JAX package's `_nn_post`. Returns
    (detected (B,), score (B,), avg_score (B,), scores_vec (B, smax))."""
    meta = static.nn_meta[j]
    n_labels = len(meta.labels)
    # Rust max_by returns the LAST maximal element on ties
    label_idx = n_labels - 1 - torch.argmax(torch.flip(logits, (-1,)), dim=-1)
    label_prob = torch.amax(logits, dim=-1)
    none_prob = (logits[:, meta.none_idx] if meta.none_idx >= 0
                 else torch.zeros_like(label_prob))
    ref10 = torch.tensor(static.score_ref * 10.0, dtype=torch.float32)
    score = nn_inverse_similarity(label_prob, none_prob, ref10)
    calc_avg = params.avg_threshold != 0.0
    # 'second' prob: the reference's reversed max_by comparator makes this
    # the MINIMUM of the probs not equal to label_prob (wakeword_nn.rs:75-88)
    others = logits != label_prob[:, None]
    second = torch.where(
        torch.any(others, dim=-1),
        torch.amin(torch.where(others, logits, INF), dim=-1),
        0.0,
    )
    avg_score = torch.where(calc_avg, nn_inverse_similarity(label_prob, second, ref10), 0.0)
    is_word = label_idx != meta.none_idx
    detected = is_word & (score >= params.threshold) & (avg_score >= params.avg_threshold)
    scores_vec = torch.nn.functional.pad(logits, (0, static.smax - n_labels))
    return detected, score, avg_score, scores_vec


def _nn_scores_one(static: StepStatic, params: StepParams, consts: ChunkConstants,
                   win: torch.Tensor, rot: torch.Tensor, j: int):
    """Score NN wakeword j on the live circular window (F, C, B) of every
    stream. Parity: wakeword_nn.rs:139-163,47-124, as the JAX package's
    `_nn_scores_one`: instead of gathering the logical-order window, the
    first layer's weights are rotated into physical frame order (zero rows
    beyond train_size, so stale slots contribute nothing):
      sum_i x_log[i]·W[i] = sum_f x_phys[f]·W[(f - rot - 1) mod F],
    the rotation an index on the device. CMN is order-free, so its mean
    uses the rotated mask."""
    ts = static.nn_meta[j].train_size
    F, C, B = win.shape
    nnc = consts.nn[j]
    lidx = (torch.arange(F, device=win.device) - rot.long() - 1) % F  # logical index
    lmask = (lidx < ts).to(torch.float32)
    mean = torch.einsum("f,fcb->cb", lmask, win) / ts  # over the logical first ts
    x = win - mean[None]
    w1r = nnc.w1p.index_select(1, lidx)  # (h1, F, C)
    h1 = w1r.shape[0]
    b1 = params.nn_params[j][0][1]
    hid = w1r.reshape(h1, F * C) @ x.reshape(F * C, B) + b1[:, None]  # (h1, B)
    logits = forward_tail(params.nn_params[j], hid.T)  # (B, labels)
    return _nn_post(static, params, logits, j)


def _nn_scores_chunk(static: StepStatic, params: StepParams, consts: ChunkConstants,
                     win: torch.Tensor, new: torch.Tensor, rot0: torch.Tensor, j: int):
    """NN det_outs for all 3 shifts of a chunk, from the virtual windows, as
    the JAX package's `_nn_scores_chunk`. The first layer folds the circular
    rotation and the CMN subtraction into one GEMM against the PRE-chunk
    window:
      dot(x - mean, W) = dot(x, W - wsum⊗maskA/ts) - wsum·mean_new,
    ((3·h1, F·C) @ (F·C, B)); the new rows enter as rank-1 corrections
    W_row · (new - old_row) at their logical positions, which are static.
    Every read of an old row is an index_select (a copy), enqueued before
    the chunk's window writes. The tail layers run on the 3 shifts merged
    into one (h, 3B) batch. Returns a list of 3 per-shift tuples."""
    ts = static.nn_meta[j].train_size
    F, C, B = win.shape
    nnc = consts.nn[j]
    h1 = nnc.w1f.shape[0]
    dev = win.device
    ar3 = torch.arange(3, device=dev)
    slots = (rot0.long() + 1 + ar3) % F
    maskA, maskB = _chunk_slot_masks(F, torch.full((1,), ts, device=dev), rot0)
    # shift s sees cursor rot0 + 1 + s: physical frame f holds logical
    # (f - rot0 - 2 - s) mod F
    lidx3 = (torch.arange(F, device=dev)[None, :] - rot0.long() - 2 - ar3[:, None]) % F
    w1r3 = nnc.w1p.index_select(1, lidx3.reshape(-1)).reshape(h1, 3, F, C).transpose(0, 1)
    # fold the CMN mean over the OLD-window rows into the weights, so the
    # window is contracted once per chunk
    w1m3 = w1r3 - nnc.wsum[None, :, None, :] * maskA[:, 0, None, :, None] / ts
    main = (w1m3.reshape(3 * h1, F * C) @ win.reshape(F * C, B)).reshape(3, h1, B)
    corr = [torch.zeros((h1, B), device=dev) for _ in range(3)]
    old = win.index_select(0, slots)  # (3, C, B): a copy, read before the writes
    for s in range(3):
        for j0 in range(s + 1):
            pos = F - (s + 1) + j0  # logical position of new row j0 at shift s
            if pos < ts:
                corr[s] = corr[s] + nnc.w1f[:, pos, :] @ (new[j0] - old[j0])
    # new-row part of the CMN mean (the old-row part is folded above)
    mean_new = torch.einsum("sj,jcb->scb", maskB[:, 0], new) / ts  # (3, C, B)
    b1 = params.nn_params[j][0][1]
    hid3 = (
        main + torch.stack(corr)
        - torch.einsum("hc,scb->shb", nnc.wsum, mean_new)
        + b1[None, :, None]
    )  # (3, h1, B)
    x = hid3.transpose(0, 1).reshape(h1, 3 * B)
    for wl, bl in params.nn_params[j][1:]:
        x = wl @ torch.relu(x) + bl[:, None]
    logits3 = x.reshape(-1, 3, B)  # (labels, 3, B)
    return [_nn_post(static, params, logits3[:, s].T, j) for s in range(3)]


def _nn_column(out):
    """An NN wakeword's per-stream tuple as one column of the wakeword axis."""
    d, sc, a, v = out
    return d[:, None], sc[:, None], a[:, None], v[:, None, :]


def _combine_batched(det_list, score_list, avg_list, scores_list):
    """Best-candidate selection over the wakeword axis, batched on streams
    (detector.rs:433-447): argmax of the detected scores, first on ties."""
    detected = torch.cat(det_list, dim=1)  # (B, W)
    score = torch.cat(score_list, dim=1)
    avg = torch.cat(avg_list, dim=1)
    scores = torch.cat(scores_list, dim=1)  # (B, W, smax)
    masked = torch.where(detected, score, -INF)
    best = torch.argmax(masked, dim=1)  # (B,)
    any_det = torch.any(detected, dim=1)
    onehot = torch.arange(score.shape[1], device=score.device)[None, :] == best[:, None]
    score_best = torch.amax(masked, dim=1)
    avg_best = torch.sum(torch.where(onehot, avg, 0.0), dim=1)
    scores_best = torch.sum(torch.where(onehot[:, :, None], scores, 0.0), dim=1)
    return any_det, best.to(torch.int32), score_best, avg_best, scores_best


def run_wakeword_detectors(static: StepStatic, params: StepParams,
                           consts: ChunkConstants, win: torch.Tensor, rot: torch.Tensor):
    """All wakewords → best candidate per stream (parity:
    detector.rs:433-447): the DTW wakewords, then each NN wakeword."""
    cols = []
    if static.n_dtw:
        cols.append(_dtw_scores(static, params, consts, win, rot))
    for j in range(len(static.nn_meta)):
        cols.append(_nn_column(_nn_scores_one(static, params, consts, win, rot, j)))
    return _combine_batched(*zip(*cols))


def run_wakeword_detectors_chunk(static: StepStatic, params: StepParams,
                                 consts: ChunkConstants, win: torch.Tensor,
                                 new: torch.Tensor, rot0: torch.Tensor):
    """All wakewords × all 3 shifts → 3 per-shift det_out tuples
    (parity: detector.rs:433-447 per shift)."""
    per_shift = [[] for _ in range(3)]
    if static.n_dtw:
        for s, out in enumerate(_dtw_scores_chunk(static, params, consts, win, new, rot0)):
            per_shift[s].append(out)
    for j in range(len(static.nn_meta)):
        for s, out in enumerate(_nn_scores_chunk(static, params, consts, win, new, rot0, j)):
            per_shift[s].append(_nn_column(out))
    return [_combine_batched(*zip(*cols)) for cols in per_shift]


# ----------------------------------------------------------- shift stages

def vad_is_voice(static: StepStatic, state: StreamState, mfcc: torch.Tensor,
                 update: torch.Tensor):
    """Energy VAD (vad.rs:11-36) for (B, C) MFCCs. `update` (B,) masks all
    state writes (the reference short-circuits is_voice when a partial is
    active). The reference's 50-slot ring is a shift register here: only the
    multiset of the last 50 values matters (min + over-threshold count)."""
    # a (B, C) view of the window-layout rows is packed first: the mean of
    # a strided row sums in another order
    value = torch.mean(torch.abs(mfcc.contiguous()), dim=-1)  # (B,)
    vwin = torch.where(
        update[:, None],
        torch.cat([state.vad_win[:, 1:], value[:, None]], dim=1),
        state.vad_win,
    )
    nan = torch.isnan(vwin)
    # min over non-NaN entries, floored at 0.01 (vad.rs:19-26)
    mn = torch.clamp(torch.amin(torch.where(nan, INF, vwin), dim=-1), min=0.01)
    th = mn * static.vad_factor
    n_high = torch.sum(~nan & (vwin > th[:, None]), dim=-1)
    vcount = torch.where(update & (n_high > 10), VAD_VOICE_FRAMES, state.vad_countdown)
    voice = vcount > 0
    vcount = torch.where(update & voice, vcount - 1, vcount).to(torch.int32)
    return state._replace(vad_win=vwin, vad_countdown=vcount), voice


def shift_count_vad(static: StepStatic, state: StreamState, mfcc: torch.Tensor,
                    active: torch.Tensor):
    """Extractor fill-count advance + emit flag + VAD gate for one shift.
    Returns (state, emit_frame (B,), should_run (B,))."""
    full = state.ext_count >= SAMPLES_PER_FRAME
    new_count = torch.clamp(state.ext_count + SAMPLES_PER_SHIFT, max=SAMPLES_PER_FRAME)
    state = state._replace(ext_count=torch.where(active, new_count, state.ext_count))
    emit_frame = active & full
    # --- process_new_mfccs VAD gate (detector.rs:377-383)
    if static.vad_enabled:
        state, voice = vad_is_voice(
            static, state, mfcc, emit_frame & ~state.partial_active
        )
        should_run = state.partial_active | voice
    else:
        should_run = torch.ones_like(emit_frame)
    return state, emit_frame, should_run


def shift_front(static: StepStatic, state: StreamState, shift: torch.Tensor,
                active: torch.Tensor):
    """Extractor buffer + MFCC + VAD for one shift (everything before the
    window write): shift (B, 160) pre-emphasized samples, active (B,).
    Returns (state, mfcc (B, C), emit_frame (B,), should_run (B,)). The
    buffer is a shift register that always rolls (where active): during
    warm-up its stale prefix is never read (extractor.rs:69-79)."""
    new_buf = torch.cat([state.ext_buf[:, SAMPLES_PER_SHIFT:], shift], dim=1)
    state = state._replace(ext_buf=torch.where(active[:, None], new_buf, state.ext_buf))
    mfcc = frontend.mfcc_from_frames(state.ext_buf, static.mfcc_size + 1)  # (B, C)
    state, emit_frame, should_run = shift_count_vad(static, state, mfcc, active)
    return state, mfcc, emit_frame, should_run


def detection_bookkeeping(static: StepStatic, params: StepParams,
                          state: StreamState, run: torch.Tensor, det_out):
    """detector.rs:398-432, fully masked by `run` (B,). det_out = the
    wakeword detectors' (any_det, best, score, avg, scores_vec) for this
    window — computed unconditionally (masked semantics)."""
    F = static.max_mfcc_frames
    i32 = torch.int32
    # countdown decrement (:399-401)
    countdown = torch.where(run & (state.countdown != 0), state.countdown - 1, state.countdown)
    done = run & state.partial_active & (
        (countdown == 0)
        | (static.eager & (state.partial_counter >= static.min_scores))
    )
    emit = done & (state.partial_counter >= static.min_scores)
    # partial is taken whenever done (:405), dropped silently if under min
    partial_active = state.partial_active & ~done
    event = Event(
        fired=emit,
        ww=state.partial_ww,
        score=state.partial_score,
        avg_score=state.partial_avg,
        counter=state.partial_counter,
        gain=state.partial_gain,
        scores=state.partial_scores,
    )
    # on emit: full reset (detector.rs:406-408,290-302) and return —
    # detectors do NOT run this frame
    run_detectors = run & ~emit
    any_det, best, score, avg, scores_vec = det_out
    cand = run_detectors & any_det
    counter = torch.where(partial_active, state.partial_counter + 1, 1)
    replace = cand & (~partial_active | (state.partial_score < score))
    new_partial_active = partial_active | cand
    state = state._replace(
        partial_active=new_partial_active & ~emit,
        partial_ww=torch.where(replace, best, state.partial_ww),
        partial_score=torch.where(replace, score, state.partial_score),
        partial_avg=torch.where(replace, avg, state.partial_avg),
        partial_scores=torch.where(replace[:, None], scores_vec, state.partial_scores),
        partial_gain=torch.where(replace, state.gain, state.partial_gain),
        # counter bumps on every candidate, replacing or not (:425-428)
        partial_counter=torch.where(cand, counter, state.partial_counter).to(i32),
        countdown=torch.where(cand, F // 2, countdown).to(i32),
    )
    # reset-on-emit: clear window, extractor, vad — not filters (:290-302)
    state = state._replace(
        win_count=torch.where(emit, 0, state.win_count).to(i32),
        ext_count=torch.where(emit, 0, state.ext_count).to(i32),
        vad_win=torch.where(emit[:, None], float("nan"), state.vad_win),
        vad_countdown=torch.where(emit, 0, state.vad_countdown).to(i32),
        partial_active=state.partial_active & ~emit,
    )
    return state, event


def _filtered(static: StepStatic) -> bool:
    return static.gain_enabled or static.bp_enabled


def filter_chunk(static: StepStatic, params: StepParams, state: StreamState,
                 samples: torch.Tensor):
    """Per-chunk front-end up to the pre-emphasis (parity: the JAX package's
    `prepare_chunk`): resample, then where a filter is on the rms of the
    samples before it, the gain normalizer (detector.rs:358-365) and the
    band-pass (:366-371). samples (B, input_samples) → (state, samples
    (B, 480)). Nothing here reads a tensor on the host. Where no filter is
    on, the rms is the caller's to take, of the samples returned.

    With a filter on, the filter's state (`gain_win`, `gain_count`, `gain`,
    `bp`) is written over the tensors of `state` in place, here and not in
    the step's commit: a step that raises after this call leaves them one
    chunk ahead of the rest of the state, so such a chunk must not be
    retried on those tensors."""
    if static.input_samples != SAMPLES_PER_FRAME:
        resample = make_torch_resampler(static.input_samples, SAMPLES_PER_FRAME,
                                        samples.device)
        overlap, samples = resample(state.rs_overlap, samples)
        state = state._replace(rs_overlap=overlap)
    if _filtered(static):
        rms = frontend.rms_level(samples)
        state = state._replace(rms_level=rms)
        gain = None
        if static.gain_enabled:
            gain = biquad.GainIn(rms, params.gain_ref_sqrt, static.gain_min, static.gain_max,
                                 state.gain_win, state.gain_count)
        bp = static.bp_coeffs if static.bp_enabled else None
        # the window, count, gain and taps are written where they lie (the
        # step commits its state into the caller's tensors anyway), so the
        # commit copies none of them
        f = biquad.front(samples.contiguous(), gain, bp, None if bp is None else state.bp,
                         win_out=state.gain_win, count_out=state.gain_count,
                         gain_out=state.gain, taps_out=state.bp)
        samples = f.out
        if gain is not None:
            state = state._replace(gain_win=f.win, gain_count=f.count, gain=f.gain)
        if bp is not None:
            state = state._replace(bp=f.taps)
    return state, samples


def prepare_chunk(static: StepStatic, params: StepParams, state: StreamState,
                  samples: torch.Tensor):
    """Per-chunk front-end (parity: the JAX package's `prepare_chunk`):
    `filter_chunk`, the rms where no filter ran, then the 3 shifts with
    per-shift pre-emphasis reset (extractor.rs:87-97). samples (B,
    input_samples) → (state, shifts (B, 3, 160)); the filters' state as
    `filter_chunk` writes it."""
    state, samples = filter_chunk(static, params, state, samples)
    if not _filtered(static):
        state = state._replace(rms_level=frontend.rms_level(samples))
    shifts = frontend.pre_emphasis(samples.reshape(-1, 3, SAMPLES_PER_SHIFT))
    return state, shifts


def _no_event(static: StepStatic, B: int, device: torch.device) -> Event:
    def z(dtype, fill=0):
        return torch.full((B,), fill, dtype=dtype, device=device)

    return Event(
        fired=z(torch.bool, False),
        ww=z(torch.int32),
        score=z(torch.float32),
        avg_score=z(torch.float32),
        counter=z(torch.int32),
        gain=z(torch.float32, float("nan")),
        scores=torch.zeros((B, static.smax), device=device),
    )


def _commit(states: StreamState, new: StreamState) -> StreamState:
    """Write every field that changed into the caller's tensors in place."""
    for old_t, new_t in zip(states, new):
        if new_t is not old_t:
            old_t.copy_(new_t)
    return states


def _constants_for(static: StepStatic):
    """constants(params) -> ChunkConstants, built when a parameter set is
    first seen and reused while the same (immutable) object is passed."""
    last = []  # [(params, its ChunkConstants)] of the last parameter set seen

    def constants(params: StepParams) -> ChunkConstants:
        if not last or last[0][0] is not params:
            last[:] = [(params, chunk_constants(static, params))]
        return last[0][1]

    return constants


def _merge_event(event: Event, ev: Event) -> Event:
    """find_map: a stream keeps the event of the shift that fired first."""
    B = event.fired.shape[0]
    return Event(*[
        torch.where(event.fired.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(event, ev)
    ])


def make_step(static: StepStatic):
    """Build step(params, states, samples (B, static.input_samples)) ->
    (states, Event (B,)):
    the per-shift stream step (`rustpotter_tpu.runtime.stream_step.make_step`)
    on a batch of B >= 1 streams. The window is stream-minor (F, C, B) with
    one shared cursor `rot`, as in the batched chunk (the JAX package's vmap
    rule keeps `rot` unbatched too).

    For each of the 3 shifts: extractor buffer, MFCC and VAD; the masked row
    write at the shift's global slot (the cursor advances every shift, the
    write only where a frame was emitted); then the window is scored
    (`run_wakeword_detectors`) and the detection bookkeeping runs. A fire
    halts the rest of that stream's shifts in this chunk (find_map,
    detector.rs:374-375). `states` is updated in place and returned."""
    F = static.max_mfcc_frames
    constants = _constants_for(static)

    def step(params: StepParams, states: StreamState, samples: torch.Tensor):
        B = samples.shape[0]
        dev = samples.device
        consts = constants(params)
        st, shifts = prepare_chunk(static, params, states, samples)  # (B, 3, 160)
        slots = (states.rot.long() + 1 + torch.arange(3, device=dev)) % F
        event = _no_event(static, B, dev)
        halted = torch.zeros((B,), dtype=torch.bool, device=dev)
        for s in range(3):
            active = ~halted
            st, mfcc, emit, should_run = shift_front(static, st, shifts[:, s], active)
            # push frame: circular write at the global slot, masked per
            # stream; the circular buffer then holds the last F pushed frames
            # (detector.rs:384-395)
            slot = slots[s:s + 1]
            old = st.win.index_select(0, slot)  # (1, C, B)
            st.win.index_copy_(0, slot, torch.where(emit[None, None, :], mfcc.T[None], old))
            win_count = torch.where(emit, torch.clamp(st.win_count + 1, max=F), st.win_count)
            st = st._replace(win_count=win_count.to(torch.int32),
                             rot=slots[s].to(torch.int32))
            det_out = run_wakeword_detectors(static, params, consts, st.win, st.rot)
            run = emit & (st.win_count >= F) & should_run
            st, ev = detection_bookkeeping(static, params, st, run, det_out)
            ev = ev._replace(fired=ev.fired & active)
            event = _merge_event(event, ev)
            halted = halted | ev.fired
        return _commit(states, st), event

    return step


def make_batched_chunk(static: StepStatic):
    """Build chunk(params, states, frames (B, static.input_samples)) ->
    (states, Event (B,)).

    `states` is updated in place and returned. The window is stream-minor
    (F, C, B), K1's native layout. `params` is immutable (a frozen
    dataclass): its ChunkConstants are built when a parameter set is first
    seen and reused while the same object is passed."""
    F = static.max_mfcc_frames
    if F < 3:
        raise ValueError(f"batched runtime requires max_mfcc_frames >= 3 (got {F})")
    C = static.mfcc_size
    constants = _constants_for(static)

    def chunk(params: StepParams, states: StreamState, frames: torch.Tensor):
        B = frames.shape[0]
        dev = frames.device
        st, samples = filter_chunk(static, params, states, frames)  # (B, 480)
        rot0 = states.rot
        slots = (rot0.long() + 1 + torch.arange(3, device=dev)) % F
        # extractor trajectory + all 3 MFCCs in one GEMM chain: the buffer
        # advances unconditionally (warm-up masking lives in ext_count); the
        # prologue writes it in place, so the commit copies none of it
        frames3, rms = frontend.prologue(samples, st.ext_buf, rms=not _filtered(static))
        if rms is not None:
            st = st._replace(rms_level=rms)
        new = frontend.mfcc_from_frames(frames3, C + 1, window=True)  # (3, C, B)

        # whole-chunk scoring against the virtual windows
        det_outs = run_wakeword_detectors_chunk(
            static, params, constants(params), st.win, new, rot0
        )

        # (B,)-vector shift loop: fill counts, VAD, bookkeeping, halt
        event = _no_event(static, B, dev)
        halted = torch.zeros((B,), dtype=torch.bool, device=dev)
        for s in range(3):
            active = ~halted
            st, emit_b, should_run_b = shift_count_vad(static, st, new[s].T, active)
            win_count = torch.where(
                emit_b, torch.clamp(st.win_count + 1, max=F), st.win_count
            ).to(torch.int32)
            st = st._replace(win_count=win_count)
            run = emit_b & (win_count >= F) & should_run_b
            st, ev = detection_bookkeeping(static, params, st, run, det_outs[s])
            fired = ev.fired & active
            event = _merge_event(event, ev._replace(fired=fired))
            halted = halted | fired

        # the 3 circular-window writes, after every read of the old window
        st.win.index_copy_(0, slots, new)
        st = st._replace(rot=slots[2].to(torch.int32))
        return _commit(states, st), event

    return chunk
