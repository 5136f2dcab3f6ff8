#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rustpotter_tpu_torch) on one CUDA card.

    python3 chip_smoke.py    # needs one card

Phases, each of which raises (non-zero exit) when it fails:
  1. print the card's name and power limit, build every kernel of the main
     paths from csrc/ with nvcc, and the host ingest library with the host
     C++ compiler (one compiler per source and variant, all at once), print
     the build seconds and the compiler's register/spill report;
  2. kernel phase: each kernel (K1 fused_dtw_v4, K2 fused_dtw_v3, K3
     banded_dtw, K4 fused_dtw_v2, K5 fused_dtw_v1) against its plain PyTorch
     version on the card, at the unit-test shapes and at the bench shapes
     (K3 bit for bit at w in {2, 5, 6, 8} with L*w odd and even; K1 and K5
     also once at w = 8, C = 16, K5 at w = 37 too, and K5 held to K4 on
     the same inputs (the share of bit-equal sims, and the instructions
     with the immediate 1 of a 1 - x*y in both SASS), with the ptxas report
     of each K5 build and its SASS row loop, which must hold fewer
     conditional branches than band cells per step),
     with its time (CUDA events over back-to-back launches, median of 20;
     K5's from kernel_probe --v1 in phase 5), the plain version's time and
     its bound; K1 and K2 also with the gate mixed and closed, with the
     FLOPs their designs execute (counted, `k1_executed`, `k2_executed`)
     and with the registers, spill bytes and shared memory that ptxas
     reports for their C = 8 and C = 16 builds and the warps per SM they
     allow (K2 is also held once at w = 9, where its ring passes 48 KB);
     K4 in each of its forms, the ring form at w = 5 and 9, the column form
     at w = 21, 24 (32 streams a block), 37 (16 streams) and 75 (one row
     per step) at the unit shapes (B = 1, 33, 50; pairs of length 1 and 2
     and pairs long enough to reuse every ring slot) and at the bench
     shapes, with the plain version's time at 21, 24 and 75, and the row
     form at w = 76, with the form and the ptxas report of each build (a
     column-form build must not spill);
     then the fp32 probes V1-V6 (tools/fma_probe.py) against
     their plain versions at reps = 16 and in each timed run at reps = 2000,
     with the plain versions' time there; then the front-end kernel
     (csrc/biquad.cu: the gain normalizer, then the band-pass biquad) bit
     for bit against its plain version on a CPU copy in each of its forms
     (gain and band-pass, band-pass only, gain only) over 3 chunks with the
     state carried in place, at B = 8192 x 480 samples (the bulk form) and B
     = 1000 x 477 (the simple form), gains over every step 0.1-1.0, with its
     time in each form (device time from a CUDA graph, a wrapper call by
     CUDA events, and a wrapper call's host time), the plain version's and
     the bounds; then the MFCC front-end's kernels (csrc/mfcc_front.cu)
     against their plain versions on the same card tensors at B = 8192 and
     65536 (the prologue bit for bit, its rms and the epilogue at their
     tolerances, both output layouts, a silent stream's rows exact), with their
     device times, the plain versions' and the bounds by bytes;
  3. batched slice phase (K1): BatchedDetector at B=8192 with the bench
     wakeword runs the bench correctness pass (stream 0 must fire, every
     chunk must launch K1), streams 0-3 must give the events of a
     device="cpu" run at B=4 on the same audio, process_sequence must give
     the pass's events bit for bit, then 5 windows of 34 chunks of noise are
     timed on the host clock per turn (streams_rt of the median window, and
     the range), and torch.profiler splits the device kernel time of 5 more
     eager chunks into front-end, K1 and the rest, listing the kernels;
  4. per-shift slice phase (K2, K3, K4): the single-stream Rustpotter on the
     card plays the correctness stream (it must fire, launch K2 3 times per
     frame and give the detections of a device="cpu" run;
     process_audio_sequence the same detections), then make_step
     at B=8192 runs the correctness pass in each kernel mode (K2 by default,
     K4 with dtw_fused_variant=2, K3 with dtw_fused=False: stream 0 must
     fire, every shift must launch the mode's kernel, streams 0-3 must give
     the events of a device="cpu" run at B=4), and the K2 and K3 modes are
     timed as in phase 3 and split by torch.profiler (K3's device time per
     chunk beside K2's; K4's too, profiled alone);
  5. tools phase (K5, V1-V6): the kernel tooling path with the counts reset
     before it: kernel_parity's seven checks at B=8192, kernel_probe in its
     five modes (--v1 K5, the time in K5's row; --v2 K4, --v4 K1, --k3 K3,
     default K2) and K4's column form at the bands K4_WIDE_BANDS (--v2
     --w=N),
     fma_probe timing
     V1-V6 at reps = 2000 (the measured fp32 FMA rate beside the data-sheet
     peak), V3's, V4's, V5's and V6's ptxas registers and spills at S = 8
     and 32 and every opcode of their SASS rep loops (which must hold no
     LDG, LDL or LDC; V3's, V4's and V6's no LDS either, and V5's its
     shared loads of s, each feeding fma_probe.sload_ffma_per_load FFMAs),
     and the host ingest library's decode; K5 and every probe must have
     launched;
  6. NN phase (K1, K2, K4): `nn_medium` (an NN wakeword alone) and `mixed`
     (the bench DTW wakeword beside it) through BatchedDetector at B=8192:
     the correctness pass with a MEDIUM classifier that fires on the bench
     utterance (stream 0 must fire, streams 0-3 must give a device="cpu"
     run's events at B=4, K1 must launch once per chunk with the DTW
     wakeword and never without), then the `nn_medium` recipe's model of the
     same shapes timed as in phase 3 and split by torch.profiler into
     front-end, NN GEMMs, K1 and the rest; the single-stream Rustpotter with
     `mixed` (3 K2 launches per frame, the cpu run's detections); the bands
     21 and 24, past K1's and K2's rings, through BatchedDetector, make_step
     and Rustpotter at B=64 on a 30-frame bench wakeword (each routes to K4,
     3 launches per chunk or frame and no other kernel; the cpu run's
     events), and at B=8192 on the bench wakeword through the graphed
     make_step (K4's column form: 3 launches per chunk of the correctness pass,
     the host clock, the graph's device time and K4's by torch.profiler); the
     NN wakeword added to a live B=8192 DTW fleet after 10 chunks (the chunks
     after it give the cpu run's events at B=4); the memory of management
     calls (`management_memory`: ten calls, add and remove in turns, each
     followed by a graphed chunk, read before and after empty_cache, which
     must stay flat per bundle; ten more without it, then one tensor as large
     as the reserved memory they left); and `reset_streams` at B=8192
     graphed against `make_reset` (`reset_turns`: bit for bit with three
     masks, host ms per call in turns, the next chunk replayed without a
     capture);
  7. audio front-end phase (K1, K2, the front-end kernel): `dtw_filters`,
     the bench wakeword at B=8192 with the gain normalizer and the 80-400 Hz
     band-pass on (__graft_entry__.entry()'s filters; stream 1 at noise
     0.062, gain 0.9), through BatchedDetector (K1 and one front-end launch
     per chunk, the profile's launches per chunk at most those of the same
     detector with the filters off plus one, and the rms's three, which the
     MFCC prologue takes without filters; each the median of 5 profiles
     taken in turns), make_step (3 K2 launches and one front-end launch per
     chunk, likewise) and Rustpotter (likewise per frame); and `dtw_48k`
     (tools/bench_suite.py's scenario: 48 kHz F32, in_graph_resample, the
     utterance synthesized at 48 kHz) through BatchedDetector (K1, no
     biquad), with Rustpotter at 48 kHz int16 through the host encoder.
     Each: stream 0 must fire, streams 0-3 (or the single stream) must give
     a device="cpu" run's events and gains, the launches per chunk are
     asserted; the host clock, and the device time per chunk split into
     front-end, resample GEMM, biquad, K1 (or K2) and the rest; ms per
     process_samples and of its host encoder;
  8. training phase (M9): synthetic.training_wavs at the `nn_medium` width
     (MEDIUM, train_size 168, mfcc_size 16: 2688 -> 56 -> 28 -> 2; 64
     training and 16 test files) trained on the card and on the CPU, 200
     epochs at lr 0.017 in chunks of 10, seed 0: the losses must agree at
     tests/test_training_torch_crosscheck.py's tolerances (the first 10
     epochs rtol 2e-4 / atol 2e-5, all rtol 5e-3 / atol 5e-4), the final
     weights too, the test accuracies must be equal; the card's model
     round-trips through save_wakeword / load_wakeword byte for byte and,
     served by BatchedDetector at B=4 over correctness_stream(168, the
     bench utterance), gives the CPU run's events (NN scores rtol 1e-4 /
     atol 1e-3). `trainer.fit` on the card (a CUDA graph of test_epochs
     epochs replayed per chunk) and its eager yardstick (`eager_fit`) over
     the same 200 epochs: losses, weights and test accuracy bit for bit.
     Then the MFCC extraction of the 80 WAVs (M2a, `extraction_phase`) in
     turns eager (`mfcc_features` called directly) / graphed / graphed /
     eager, split into host encoder and device pipeline, bit for bit, with
     one capture, and its launches and device ms per WAV eager and per
     replay (torch.profiler); the bench wakeword built from WAV bytes of the
     5 bench utterances, graphed bit-equal to eager and to a device="cpu"
     build at rtol 1e-5 / atol 1e-4; the reference's 1000
     epochs through train_from_buffers on the host clock, the epochs alone
     in turns eager (`eager_fit`) / graph (`fit`) / graph / eager, a graphed
     call's first chunk (eager, then the capture), the graph's device time
     per epoch by CUDA events around replays, and torch.profiler's device
     time and launches per epoch of a replay and of the eager chunk: a
     replay must run the eager chunk's kernels, each as often, plus its
     input copy and its output's clone, and end on the same weights. With
     two cards or more, F3's check (`f3_check`: K2 at w = 9, K3, K1 at w =
     10 on cuda:0, then on cuda:1, each against the CPU); with one, a line
     says it was not run;
  9. sharding phase (M11): a world-1 NCCL group (file:// rendezvous; one
     process per card, so one rank here), BatchedDetector sharded over it
     at B=8192 with the bench wakeword through the correctness pass (stream
     0 must fire, K1 once per chunk), every event field bit-equal to the
     unsharded detector's; gather_detections and fleet_detection_count
     return the local values; the host clock per chunk, sharded and
     unsharded in turns, and the gather plus count per chunk; then
     parallel.dryrun.dryrun_multigpu over every card (one NCCL rank each).
Every serving path of phases 3, 4, 6, 7 and 9 goes through the graphed entry
points (runtime/graph.py: BatchedDetector.process_chunk and process_sequence,
Rustpotter.process_samples and process_audio_sequence, make_step wrapped in
GraphedStep), each held to the eager function (make_batched_chunk, make_step,
or `EagerSingleStream`, Rustpotter's frame loop over make_step) on the same
audio: the launches counted per replay equal the eager run's, the events of
every stream are equal (scores, gains and final states within the tolerances
above), whether every bit is equal is printed, and torch.profiler must see a
replay run the port's kernels as counted (`replays_run`). M6b also times a
bundle's first chunk (the eager chunk, then the capture) against a replay and
reads the memory reserved over each capture. The host clock of graph and eager is
taken in turns (eager, graph, graph, eager) for the batched chunk, the K2
step, `nn_medium`, `mixed`, `dtw_filters` (batched and make_step),
`dtw_48k` and the single-stream Rustpotter, with the graph's device time by
CUDA events around replays; torch.profiler splits the eager function, where
its launch counts are the chunk's.
The line before the last is the kernels JSON; the last line is the result
JSON. Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from rustpotter_tpu_torch.utils.profiling import (  # noqa: E402
    H100,
    bound,
    device_kernels,
    dp_work,
    immediate_ops,
    host_ms_per_call,
    innermost_loop,
    k1_bytes,
    k3_work,
    k1_executed,
    k1_work,
    k2_executed,
    k4_column_executed,
    k4_executed,
    linear_bytes,
    loop_facts,
    profiled_launches,
    ptxas_resources,
    resident_warps,
    sass_functions,
    sass_listing,
    shift_bytes,
    time_cuda,
    time_cuda_graph,
)

# kernels vs their plain versions: the JAX kernel tests' own tolerances (K3,
# adds and mins only, must be bit-exact)
RTOL, ATOL, ATOL_V2 = 3e-6, 2e-4, 1e-4
# the fp32 probes vs their plain versions: V1-V4 add exact halves in the plain
# version's order (bit-exact, rtol 0); V5 and V6 fuse a product that the plain
# version rounds first (rtol by reps and S: fma_probe.PROBE_RTOL)
EV_RTOL, EV_ATOL = 2e-5, 2e-5  # event scores, card vs CPU
MFCC_RTOL, MFCC_ATOL = 1e-5, 1e-4  # MFCCs, card vs CPU (tests/test_torch_frontend.py)
NN_RTOL, NN_ATOL = 1e-4, 1e-3  # NN logits and scores, card vs CPU
BENCH_STREAMS = 8192  # bench.py's B
TIMED_CHUNKS = 34  # bench.py's T: ~1 s of audio per stream
TIMED_WINDOWS = 5
PROFILED_CHUNKS = 5
# replays_run's profiles per side: the median of 3 outvotes one profile that
# dropped a replay's records (12 of 15 K4 launches read from 5 replays on an H100)
REPLAY_READINGS = 3
PROFILE_ROWS = 20
REPLAY_PROFILES = {"paths": 0, "s": 0.0}  # replays_run's calls and host seconds
# kernel sources built per MFCC size (C = 8 for the unit shapes, 16 for the
# bench wakeword); banded_dtw.cu depends on the band only
SOURCES_C = ("fused_dtw_v4.cu", "fused_dtw_v3.cu", "fused_dtw_v2.cu", "fused_dtw_v1.cu")
K3_BANDS = (2, 5, 6, 8)  # K3's tile is sized from the band: bit-exact at each
# wider bands, held once at C = 16: K5's rings and K1's, K2's and K4's rings
# grow with w (K2's passes 48 KB of shared memory from w = 9, K4's from 8); K4
# takes its column form past w = 19 (32 streams a block, 16 from 37, one row
# per step at 75) and its row form past 75, K5 one row per step at 37
WIDE = (("fused_dtw_v1.cu", 8), ("fused_dtw_v1.cu", 37), ("fused_dtw_v4.cu", 8),
        ("fused_dtw_v3.cu", 9), ("fused_dtw_v2.cu", 9), ("fused_dtw_v2.cu", 21),
        ("fused_dtw_v2.cu", 24), ("fused_dtw_v2.cu", 37), ("fused_dtw_v2.cu", 75),
        ("fused_dtw_v2.cu", 76))
K4_ROW_BANDS = (21, 24)  # F1's bands: K4's column form on the graphed make_step
K4_WIDE_BANDS = (21, 24, 75)  # K4's column form and its plain version timed at the bench's B


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ------------------------------------------------------------------ K1

def k1_inputs(rng, B, F, Lm, C, D, K, scale, device):
    import torch

    P = D * K + D
    t = lambda a: torch.tensor(a.astype(np.float32), device=device)
    tpl = rng.normal(0, 1, (P, Lm, C)).astype(np.float32)
    return dict(
        win=t(rng.normal(0, scale, (F, C, B))),
        new=t(rng.normal(0, scale, (3, C, B))),
        means3=t(rng.normal(0, 0.2 * scale, (3, P, C, B))),
        templates=t(tpl),
        tnorms=t(np.sum(tpl ** 2, axis=-1)),
    )


def mid_bound(avg):
    """A gate bound in the middle of the widest gap between the avg sims of
    the middle fifth, so that about half the streams pass and none sits near
    the bound (K1 and its plain version differ in the last bits)."""
    v = avg.flatten().sort().values
    lo, hi = v.numel() * 2 // 5, max(v.numel() * 3 // 5, v.numel() * 2 // 5 + 2)
    i = lo + int((v[lo + 1:hi] - v[lo:hi - 1]).argmax())
    return ((v[i] + v[i + 1]) / 2).reshape(1)


def compare(got, want, name="K1", atol=ATOL):
    """Max |Δ| over finite entries; raises unless the +inf pattern is equal
    and the finite entries agree within (RTOL, atol)."""
    import torch

    g, w = got.double().cpu(), want.double().cpu()
    if not torch.equal(torch.isinf(g), torch.isinf(w)):
        raise AssertionError(f"{name} and its plain version disagree on which sims are +inf")
    fin = torch.isfinite(w)
    if not torch.equal(fin, torch.isfinite(g)):
        raise AssertionError(f"{name} and its plain version disagree on finiteness")
    torch.testing.assert_close(g[fin], w[fin], rtol=RTOL, atol=atol)
    return float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0


def kernel_phase(dev, record):
    import torch

    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import fused_dtw as fd

    rng = np.random.default_rng(6)
    worst = 0.0
    # unit-test shapes: F in {Lm, Lm+2, Lm+9}, wrap-around cursor, gates
    D, K, B, Lm, C, w = 2, 2, 30, 40, 8, 5
    lens = (40, 31, 28, 37, 35, 40)
    for F in (Lm, Lm + 2, Lm + 9):
        x = k1_inputs(rng, B, F, Lm, C, D, K, 1.0, dev)
        rot0 = torch.tensor(F - 2, dtype=torch.int32, device=dev)
        args = lambda gate: (x["win"], x["new"], x["means3"], x["templates"],
                             x["tnorms"], gate, lens, w, D, K, rot0)
        open_ = torch.full((D,), float("inf"), device=dev)
        want = fd.fused_dtw_chunk_v4_ref(*args(open_))
        worst = max(worst, compare(fd.fused_dtw_chunk_v4(*args(open_)), want))
        avg0 = want[:, :, D * K]
        closed = torch.stack([avg0.min() - 1.0, open_[1]])
        got = fd.fused_dtw_chunk_v4(*args(closed))
        assert torch.isinf(got[:, :, :K]).all(), "closed gate left ww0 templates finite"
        worst = max(worst, compare(got, fd.fused_dtw_chunk_v4_ref(*args(closed))))
        mixed = torch.cat([mid_bound(avg0), open_[1:]])
        got = fd.fused_dtw_chunk_v4(*args(mixed))
        worst = max(worst, compare(got, fd.fused_dtw_chunk_v4_ref(*args(mixed))))
        passing = (avg0 <= mixed[0])[..., None].expand(-1, -1, K)
        assert torch.equal(torch.isfinite(got[:, :, :K]), passing), "mixed gate"
        log(f"K1 unit shapes F={F}: ok")

    # bench shapes: B=8192, one wakeword of 5 templates + avg, F=Lm=100, C=16
    D, K, B, Lm, C, w, F = 1, 5, BENCH_STREAMS, 100, 16, 5, 100
    P = D * K + D
    lens = (100, 98, 96, 94, 92, 100)
    x = k1_inputs(rng, B, F, Lm, C, D, K, 5.0, dev)
    rot0 = torch.tensor(37, dtype=torch.int32, device=dev)
    args = lambda gate: (x["win"], x["new"], x["means3"], x["templates"],
                         x["tnorms"], gate, lens, w, D, K, rot0)
    open_ = torch.full((D,), float("inf"), device=dev)
    want = fd.fused_dtw_chunk_v4_ref(*args(open_))
    got = fd.fused_dtw_chunk_v4(*args(open_))
    err_open = compare(got, want)
    log(f"K1 bench shapes: max|d| of avg sims {compare(got[:, :, D * K:], want[:, :, D * K:]):.3e}")
    mixed = mid_bound(want[:, :, D * K])
    err_mixed = compare(fd.fused_dtw_chunk_v4(*args(mixed)), fd.fused_dtw_chunk_v4_ref(*args(mixed)))
    closed = want[:, :, D * K].min().reshape(1) - 1.0
    got = fd.fused_dtw_chunk_v4(*args(closed))
    assert torch.isinf(got[:, :, :D * K]).all(), "K1 bench: closed gate left templates finite"
    err_closed = compare(got, fd.fused_dtw_chunk_v4_ref(*args(closed)))
    worst = max(worst, err_open, err_mixed, err_closed)
    log(f"K1 bench shapes: max|d| open {err_open:.3e} mixed {err_mixed:.3e} closed "
        f"{err_closed:.3e}")
    # a wider band, w = 8, once (its ring passes K1's w = 5 size 2.2 times)
    args8 = (x["win"], x["new"], x["means3"], x["templates"], x["tnorms"], open_, lens, 8, D,
             K, rot0)
    err8 = compare(fd.fused_dtw_chunk_v4(*args8), fd.fused_dtw_chunk_v4_ref(*args8))
    worst = max(worst, err8)
    log(f"K1 bench shapes at w=8: max|d| {err8:.3e}")
    torch.cuda.synchronize()

    # the kernel alone: T' prepared once, as the serving chunk does
    tset = fd.prepare_templates(x["templates"], x["tnorms"], lens, w)
    launch = lambda gate: fd.score_chunk(x["win"], x["new"], x["means3"], tset, gate, D, K, rot0)
    ms = time_cuda(lambda: launch(open_))
    plain_ms = time_cuda(lambda: fd.fused_dtw_chunk_v4_ref(*args(open_)), samples=5, per=1,
                         warmup=1)
    ms_mixed = time_cuda(lambda: launch(mixed))
    ms_closed = time_cuda(lambda: launch(closed))
    dots, rest = k1_work(lens, w, C, B)
    flops = dots + rest
    executed = k1_executed(lens, w, C, B)
    nbytes = k1_bytes(F, C, B, P, Lm)
    t_ops, t_bytes = bound(flops, 0)[0], bound(0, nbytes)[0]
    log(f"K1 bench gate open: {ms:.4f} ms (gate mixed {ms_mixed:.4f} ms, closed "
        f"{ms_closed:.4f} ms), plain {plain_ms:.3f} ms; needs {flops / 1e9:.4f} GFLOP (dots "
        f"{dots / 1e9:.4f}, rest {rest / 1e9:.4f}; {t_ops:.4f} ms at {H100.fp32_tflops:.0f} "
        f"TFLOP/s) and {nbytes / 1e6:.2f} MB ({t_bytes:.4f} ms at {H100.hbm_gbps / 1e3:.2f} "
        f"TB/s); its design executes {executed / 1e9:.4f} GFLOP (counted by k1_executed, not "
        f"measured), {executed / ms / 1e9:.3f} TFLOP/s at that count")
    for c in (8, 16):
        r = ptxas_resources(_build.build_log(fd.SOURCE, {"RP_C": c, "RP_W": w}))
        smem = r["static_smem"] + fd.k1_smem_bytes(w, c)  # the .cu's RING_BYTES, dynamic
        log(f"K1 build C={c} w={w} (ptxas): {r['registers']} registers, {r['spill_bytes']} "
            f"bytes of spill stores, {smem} bytes of shared memory per block of 96 threads: "
            f"{resident_warps(r['registers'], 96, smem)} warps per SM")
    record["fused_dtw_v4"] = {
        "name": "fused_dtw_v4",
        "route": "cuda",
        "source": "rustpotter_tpu_torch/csrc/fused_dtw_v4.cu",
        "replaces": "rustpotter_tpu/ops/fused_dtw.py:431",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "ms_gate_mixed": ms_mixed,
        "ms_gate_closed": ms_closed,
    }


# ------------------------------------------------------------ K2, K3, K4

def kernel_row(name, source, replaces, err, ms, plain_ms, flops, nbytes):
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"{name} bench: {ms:.4f} ms, plain {plain_ms:.3f} ms; needs {flops / 1e9:.4f} GFLOP "
        f"and {nbytes / 1e6:.2f} MB: bound {bound_ms:.4f} ms by {bound_by}")
    return {"name": name, "route": "cuda", "source": f"rustpotter_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def v3_inputs(rng, B, F, Lm, C, P, scale, device):
    import torch

    t = lambda a: torch.tensor(a.astype(np.float32), device=device)
    tpl = rng.normal(0, 1, (P, Lm, C)).astype(np.float32)
    return dict(win=t(rng.normal(0, scale, (F, C, B))),
                means=t(rng.normal(0, 0.2 * scale, (P, C, B))),
                templates=t(tpl), tnorms=t(np.sum(tpl ** 2, axis=-1)))


def k2_phase(dev, record):
    """K2 (fused_dtw_batch_v3_t) against fused_dtw_batch_v3_ref."""
    import torch

    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import fused_dtw as fd

    rng = np.random.default_rng(7)
    worst = 0.0
    D, K, Lm, C, w = 2, 2, 40, 8, 5
    lens = (40, 31, 28, 37, 35, 40)
    for F, B in ((Lm, 30), (Lm + 2, 33), (Lm + 9, 1)):
        x = v3_inputs(rng, B, F, Lm, C, D * K + D, 1.0, dev)
        rot = torch.tensor(F - 2, dtype=torch.int32, device=dev)  # wraps around
        args = lambda gate: (x["win"], x["means"], x["templates"], x["tnorms"], gate,
                             lens, w, D, K, rot)
        open_ = torch.full((D,), float("inf"), device=dev)
        want = fd.fused_dtw_batch_v3_ref(*args(open_))
        worst = max(worst, compare(fd.fused_dtw_batch_v3_t(*args(open_)), want, "K2"))
        avg0 = want[:, D * K]
        closed = torch.stack([avg0.min() - 1.0, open_[1]])
        got = fd.fused_dtw_batch_v3_t(*args(closed))
        assert torch.isinf(got[:, :K]).all(), "K2: closed gate left ww0 templates finite"
        worst = max(worst, compare(got, fd.fused_dtw_batch_v3_ref(*args(closed)), "K2"))
        mixed = torch.cat([mid_bound(avg0) if B > 1 else avg0 + 1.0, open_[1:]])
        got = fd.fused_dtw_batch_v3_t(*args(mixed))
        worst = max(worst, compare(got, fd.fused_dtw_batch_v3_ref(*args(mixed)), "K2"))
        passing = (avg0 <= mixed[0])[:, None].expand(-1, K)
        assert torch.equal(torch.isfinite(got[:, :K]), passing), "K2: mixed gate"
        log(f"K2 unit shapes F={F} B={B}: ok")

    D, K, B, Lm, C, w, F = 1, 5, BENCH_STREAMS, 100, 16, 5, 100
    P = D * K + D
    lens = (100, 98, 96, 94, 92, 100)
    x = v3_inputs(rng, B, F, Lm, C, P, 5.0, dev)
    rot = torch.tensor(37, dtype=torch.int32, device=dev)
    args = lambda gate: (x["win"], x["means"], x["templates"], x["tnorms"], gate,
                         lens, w, D, K, rot)
    open_ = torch.full((D,), float("inf"), device=dev)
    want = fd.fused_dtw_batch_v3_ref(*args(open_))
    err_open = compare(fd.fused_dtw_batch_v3_t(*args(open_)), want, "K2")
    mixed = mid_bound(want[:, D * K])
    err_mixed = compare(fd.fused_dtw_batch_v3_t(*args(mixed)),
                        fd.fused_dtw_batch_v3_ref(*args(mixed)), "K2")
    closed = want[:, D * K].min().reshape(1) - 1.0
    got = fd.fused_dtw_batch_v3_t(*args(closed))
    assert torch.isinf(got[:, :D * K]).all(), "K2 bench: closed gate left templates finite"
    err_closed = compare(got, fd.fused_dtw_batch_v3_ref(*args(closed)), "K2")
    worst = max(worst, err_open, err_mixed, err_closed)
    log(f"K2 bench shapes: max|d| open {err_open:.3e} mixed {err_mixed:.3e} closed "
        f"{err_closed:.3e}")
    # a wider band, w = 9, once (its ring passes the 48 KB default there)
    args9 = (x["win"], x["means"], x["templates"], x["tnorms"], open_, lens, 9, D, K, rot)
    err9 = compare(fd.fused_dtw_batch_v3_t(*args9), fd.fused_dtw_batch_v3_ref(*args9), "K2")
    worst = max(worst, err9)
    log(f"K2 bench shapes at w=9: max|d| {err9:.3e}")
    # the launch alone: T' and dotm prepared, as the per-shift step has them
    tset = fd.prepare_templates(x["templates"], x["tnorms"], lens, w)
    dotm = torch.einsum("plc,pcb->plb", tset.tp, x["means"]).contiguous()
    launch = lambda gate: fd.launch_v3(x["win"], x["means"], dotm, tset, gate, D, K, rot)
    ms = time_cuda(lambda: launch(open_))
    ms_mixed = time_cuda(lambda: launch(mixed))
    ms_closed = time_cuda(lambda: launch(closed))
    plain_ms = time_cuda(lambda: fd.fused_dtw_batch_v3_ref(*args(open_)), samples=5, per=1,
                         warmup=1)
    executed = k2_executed(lens, w, C, B)
    log(f"K2 bench gate open: {ms:.4f} ms (gate mixed {ms_mixed:.4f} ms, closed "
        f"{ms_closed:.4f} ms); its design executes {executed / 1e9:.4f} GFLOP (counted by "
        f"k2_executed, not measured), {executed / ms / 1e9:.3f} TFLOP/s at that count")
    for c in (8, 16):
        r = ptxas_resources(_build.build_log(fd.SOURCE_V3, {"RP_C": c, "RP_W": w}))
        smem = r["static_smem"] + fd.k2_smem_bytes(w, c)
        log(f"K2 build C={c} w={w} (ptxas): {r['registers']} registers, {r['spill_bytes']} "
            f"bytes of spill stores, {smem} bytes of shared memory per block of 160 threads: "
            f"{resident_warps(r['registers'], 160, smem)} warps per SM")
    flops = B * sum(dp_work(n, w, C, False) for n in lens)
    nbytes = shift_bytes(Lm, C, B, P, D)
    record["fused_dtw_v3"] = kernel_row("fused_dtw_v3", "fused_dtw_v3.cu",
                                        "rustpotter_tpu/ops/fused_dtw.py:273", worst, ms,
                                        plain_ms, flops, nbytes)
    record["fused_dtw_v3"].update(ms_gate_mixed=ms_mixed, ms_gate_closed=ms_closed)


def k4_phase(dev, record):
    """K4 (fused_dtw_batch, variant 2) against fused_dtw_batch_ref, in each
    of its forms."""
    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import fused_dtw as fd

    rng = np.random.default_rng(8)
    worst = 0.0
    Lm, C, w = 60, 8, 5
    lens = (60, 41, 33, 55)
    for B in (50, 33, 1):
        x = v3_inputs(rng, B, Lm, Lm, C, len(lens), 1.0, dev)
        win, means = x["win"].permute(2, 0, 1), x["means"].permute(2, 0, 1)  # (B, Lm, C), (B, P, C)
        args = (win, means, x["templates"], x["tnorms"], lens, w)
        worst = max(worst, compare(fd.fused_dtw_batch(*args), fd.fused_dtw_batch_ref(*args),
                                   "K4", ATOL_V2))
        log(f"K4 unit shapes B={B}: ok")
    wide = [wb for src, wb in WIDE if src == "fused_dtw_v2.cu"]
    # the wider forms at unit shapes, C = 16: pairs of length 1 and 2, and
    # pairs long enough that the column form reuses every ring slot at
    # every place of a step (n > its slots x rows per step, 196 at w = 21)
    worst_col = 0.0
    Lm16 = 200
    lens16 = (Lm16, 2, 1, Lm16 - 1, Lm16 // 2, 9)
    for wb in (wb for wb in wide if fd.k4_form(wb, 16) != "ring"):
        for B in (50, 33, 1):
            x = v3_inputs(rng, B, Lm16, Lm16, 16, len(lens16), 1.0, dev)
            args = (x["win"].permute(2, 0, 1), x["means"].permute(2, 0, 1), x["templates"],
                    x["tnorms"], lens16, wb)
            err = compare(fd.fused_dtw_batch(*args), fd.fused_dtw_batch_ref(*args), "K4", ATOL_V2)
            worst = max(worst, err)
            if fd.k4_form(wb, 16) == "column":
                worst_col = max(worst_col, err)
        log(f"K4 unit shapes at w={wb}, C=16 ({fd.k4_form(wb, 16)} form, "
            f"{fd.k4_column_plan(wb, 16) or 'no'} (streams, rows per step)), B=50, 33, 1: ok")

    B, Lm, C, w = BENCH_STREAMS, 100, 16, 5
    lens = (100, 98, 96, 94, 92, 100)
    P = len(lens)
    x = v3_inputs(rng, B, Lm, Lm, C, P, 5.0, dev)
    args = (x["win"].permute(2, 0, 1), x["means"].permute(2, 0, 1), x["templates"],
            x["tnorms"], lens, w)
    err = compare(fd.fused_dtw_batch(*args), fd.fused_dtw_batch_ref(*args), "K4", ATOL_V2)
    worst = max(worst, err)
    log(f"K4 bench shapes: max|d| {err:.3e}")
    # the wider builds: the ring form past 48 KB (w = 9), the column form
    # (w = 21, 24; 16 streams a block at 37, one row per step at 75), the row
    # form (76)
    plain_wide = {}
    for wb in wide:
        argsw = (*args[:5], wb)
        errw = compare(fd.fused_dtw_batch(*argsw), fd.fused_dtw_batch_ref(*argsw), "K4",
                       ATOL_V2)
        worst = max(worst, errw)
        if fd.k4_form(wb, C) == "column":
            worst_col = max(worst_col, errw)
        if wb in K4_WIDE_BANDS:
            plain_wide[wb] = time_cuda(lambda: fd.fused_dtw_batch_ref(*argsw), samples=3, per=1,
                                       warmup=0)
        log(f"K4 bench shapes at w={wb} ({fd.k4_form(wb, C)} form): max|d| {errw:.3e}"
            + (f"; plain version {plain_wide[wb]:.3f} ms" if wb in plain_wide else ""))
    tset = fd.prepare_templates(x["templates"], x["tnorms"], lens, w)
    ms = time_cuda(lambda: fd.score_linear(x["win"], x["means"], tset))
    plain_ms = time_cuda(lambda: fd.fused_dtw_batch_ref(*args), samples=5, per=1, warmup=1)
    flops = B * sum(dp_work(n, w, C, True) for n in lens)
    nbytes = linear_bytes(Lm, C, B, P)
    executed = k4_executed(lens, w, C, B)
    log(f"K4 bench: its design executes {executed / 1e9:.4f} GFLOP (counted by "
        f"k4_executed, not measured; {flops / 1e9:.4f} needed), {executed / ms / 1e9:.3f} "
        "TFLOP/s at that count")
    for c, wb in [(8, w), (16, w)] + [(16, wb) for wb in wide]:
        r = ptxas_resources(_build.build_log("fused_dtw_v2.cu", {"RP_C": c, "RP_W": wb}))
        form = fd.k4_form(wb, c)
        plan = fd.k4_column_plan(wb, c) if form == "column" else None
        threads = (32 * (fd.K4_PRODUCERS + 1) if form == "ring"
                   else (plan[0] if plan else 32) * min(P, fd.MAX_JOBS))
        smem = r["static_smem"] + fd.k4_smem_bytes(wb, c)
        log(f"K4 build C={c} w={wb} ({form} form"
            + (f", {plan[0]} streams a block, {plan[1]} rows per step" if plan else "")
            + f", ptxas): {r['registers']} registers, {r['spill_bytes']} bytes of spill stores, "
            f"{smem} bytes of shared memory per block of {threads} threads: "
            f"{resident_warps(r['registers'], threads, smem)} warps per SM")
        if form == "column" and r["spill_bytes"]:
            raise AssertionError(f"K4's column form spills at C={c} w={wb}")
    record["fused_dtw_v2"] = kernel_row("fused_dtw_v2", "fused_dtw_v2.cu",
                                        "rustpotter_tpu/ops/fused_dtw.py:167", worst, ms,
                                        plain_ms, flops, nbytes)
    # the column form at F1's first band, w = 21: its launches are read on
    # the graphed make_step at that band (nn_phase), its time also by
    # kernel_probe at K4_WIDE_BANDS (tools_phase)
    wc = K4_ROW_BANDS[0]
    tset_c = fd.prepare_templates(x["templates"], x["tnorms"], lens, wc)
    ms_c = time_cuda(lambda: fd.score_linear(x["win"], x["means"], tset_c))
    flops_c = B * sum(dp_work(n, wc, C, True) for n in lens)
    rows = fd.k4_column_plan(wc, C)[1]
    executed = k4_column_executed(lens, wc, C, B, rows)
    log(f"K4 column form bench at w={wc}: its design executes {executed / 1e9:.4f} GFLOP "
        f"(counted by k4_column_executed, not measured; {flops_c / 1e9:.4f} needed), "
        f"{executed / ms_c / 1e9:.3f} TFLOP/s at that count")
    record["fused_dtw_v2_column"] = kernel_row(
        "fused_dtw_v2_column", "fused_dtw_v2.cu",
        "rustpotter_tpu/ops/fused_dtw.py:167 (bands w > 19)", worst_col, ms_c, plain_wide[wc],
        flops_c, nbytes)
    record["fused_dtw_v2_column"]["band"] = wc
    record["fused_dtw_v2_column"]["plain_ms_by_band"] = plain_wide


def k3_phase(dev, record):
    """K3 (banded_dtw_kernel) against banded_dtw_batch: bit for bit."""
    import torch

    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import banded_dtw as bd
    from rustpotter_tpu_torch.ops.dtw import banded_dtw_batch

    rng = np.random.default_rng(9)

    def hold(lens, L, w):
        N = len(lens)
        costs = torch.tensor(rng.uniform(0, 2, (N, L, 2 * w)).astype(np.float32), device=dev)
        lens_t = torch.tensor(lens.astype(np.int32), device=dev)
        got = bd.banded_dtw_kernel(costs, lens_t, w)
        want = banded_dtw_batch(costs, lens_t, w)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K3 is not bit-exact at N={N}, L={L}, w={w}: {bad} entries "
                                 "differ")
        log(f"K3 shapes N={N} L={L} w={w} (L*w {'odd' if L * w % 2 else 'even'}): bit-exact")
        return costs, lens_t

    # unit shapes (tests/test_dtw_and_scoring.py's) at every band built,
    # lengths 1, 2 and L among them, and an odd L*w (rows not 16-byte aligned)
    for w in K3_BANDS:
        for L in (60, 59):
            lens = rng.integers(1, L + 1, 300)
            lens[:3] = (1, 2, L)
            hold(lens, L, w)
    hold(np.array([2]), 2, 5)
    # the per-shift step's shapes: N = B*P DPs of the bench pairs
    w = 5
    bench_lens = np.tile(np.array([100, 98, 96, 94, 92, 100], np.int32), BENCH_STREAMS)
    costs, lens_t = hold(bench_lens, 100, w)
    ms = time_cuda(lambda: bd.banded_dtw_kernel(costs, lens_t, w))
    plain_ms = time_cuda(lambda: banded_dtw_batch(costs, lens_t, w), samples=5, per=1, warmup=1)
    flops, nbytes = k3_work(bench_lens, w, 100)  # the costs of the rows needed, lens, out
    r = ptxas_resources(_build.build_log(bd.SOURCE, {"RP_W": w}))
    smem = r["static_smem"] + bd.smem_bytes(w)
    log(f"K3 build w={w} (ptxas): {r['registers']} registers, {r['spill_bytes']} bytes of "
        f"spill stores, {smem} bytes of shared memory per block of {bd.WARPS * 32} threads: "
        f"{resident_warps(r['registers'], bd.WARPS * 32, smem)} warps per SM")
    record["banded_dtw"] = kernel_row("banded_dtw", "banded_dtw.cu",
                                      "rustpotter_tpu/ops/pallas_dtw.py:31", 0.0, ms, plain_ms,
                                      flops, nbytes)


def _k_insns(source, C, w, kernel):
    """The SASS instructions of the function `kernel` in the build of
    `source` at (C, w)."""
    from rustpotter_tpu_torch import _build

    lib = _build.build(source, {"RP_C": C, "RP_W": w})
    return next(i for f, i in sass_functions(sass_listing(lib, _build.nvcc())).items()
                if kernel in f)


def k5_phase(dev, record):
    """K5 (fused_dtw_batch, variant 1) against fused_dtw_batch_ref and beside
    K4, the plain version's time, and each build's ptxas report and SASS row
    loop. The kernel's time and bound come from kernel_probe --v1 in the
    tools phase, on the same inputs."""
    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import fused_dtw as fd
    from rustpotter_tpu_torch.tools import kernel_probe

    rng = np.random.default_rng(10)
    worst = 0.0
    Lm, C, w = 60, 8, 5
    lens = (60, 41, 33, 55)
    for B in (50, 33, 1):
        x = v3_inputs(rng, B, Lm, Lm, C, len(lens), 1.0, dev)
        win, means = x["win"].permute(2, 0, 1), x["means"].permute(2, 0, 1)
        args = (win, means, x["templates"], x["tnorms"], lens, w)
        worst = max(worst, compare(fd.fused_dtw_batch(*args, variant=1),
                                   fd.fused_dtw_batch_ref(*args), "K5", ATOL_V2))
        log(f"K5 unit shapes B={B}: ok")

    # the kernel probe's bench shapes and inputs
    x = kernel_probe.inputs(BENCH_STREAMS, 1, dev)
    args = (x["win"], x["means"], x["templates"], x["tnorms"], kernel_probe.LENS,
            kernel_probe.W)
    err = compare(fd.fused_dtw_batch(*args, variant=1), fd.fused_dtw_batch_ref(*args), "K5",
                  ATOL_V2)
    worst = max(worst, err)
    plain_ms = time_cuda(lambda: fd.fused_dtw_batch_ref(*args), samples=5, per=1, warmup=1)
    log(f"K5 bench shapes: max|d| {err:.3e}; plain {plain_ms:.3f} ms")
    # K4 on the same inputs: the same operations in the same order, but for
    # the cost of one band slot, whose product K4's compiled code rounds
    k4, k5 = fd.fused_dtw_batch(*args, variant=2), fd.fused_dtw_batch(*args, variant=1)
    err4 = compare(k5, k4, "K5 against K4", ATOL_V2)
    k4_ones = immediate_ops(_k_insns("fused_dtw_v2.cu", 16, w, "score_pairs_v2"), "1")
    log(f"K5 bench shapes: {float((k5 == k4).float().mean()):.4%} of the sims bit-equal to "
        f"K4's on the same inputs, max|d| {err4:.3e}; instructions with the immediate 1 in "
        f"K4's SASS {dict(k4_ones)}")
    # the wider bands at C = 16: w = 8 (rings in dynamic shared memory), w = 37
    # (one row per step, the largest band whose rings fit the opt-in)
    for wide in (wb for src, wb in WIDE if src == "fused_dtw_v1.cu"):
        argsw = (*args[:5], wide)
        errw = compare(fd.fused_dtw_batch(*argsw, variant=1), fd.fused_dtw_batch_ref(*argsw),
                       "K5", ATOL_V2)
        worst = max(worst, errw)
        log(f"K5 bench shapes at w={wide} ({fd.k5_rows_per_step(wide, 16)} rows per step): "
            f"max|d| {errw:.3e}")
    for c, wb in [(8, w), (16, w)] + [(16, wb) for src, wb in WIDE if src == "fused_dtw_v1.cu"]:
        d = {"RP_C": c, "RP_W": wb}
        r = ptxas_resources(_build.build_log("fused_dtw_v1.cu", d))
        smem = fd.k5_smem_bytes(wb, c)  # static or dynamic, by the build
        threads = 32 * min(len(kernel_probe.LENS), fd.MAX_JOBS)
        insns = _k_insns("fused_dtw_v1.cu", c, wb, "score_pairs_v1")
        loop = loop_facts(insns, *innermost_loop(insns, ("BAR",)))
        lds = {k: v for k, v in sorted(loop["full_ops"].items()) if k.startswith("LDS")}
        imad_hi = sum(v for k, v in loop["full_ops"].items() if k.startswith("IMAD.HI"))
        log(f"K5 build C={c} w={wb} ({fd.k5_rows_per_step(wb, c)} rows per step, ptxas): "
            f"{r['registers']} registers, {r['spill_bytes']} bytes of spill stores, {smem} bytes "
            f"of shared memory per block of {threads} threads: "
            f"{resident_warps(r['registers'], threads, smem)} warps per SM; SASS row loop: "
            f"{loop['insns']} instructions, {loop['basic_blocks']} basic blocks, "
            f"{loop['conditional_branches']} conditional branches, FFMA {loop['ops']['FFMA']}, "
            f"LDS {lds}, IMAD.HI {imad_hi}, BAR {loop['ops']['BAR']}; instructions with the "
            f"immediate 1 {dict(immediate_ops(insns, '1'))}")
        # a guard per band cell would make a conditional branch per cell
        cells = 2 * wb * fd.k5_rows_per_step(wb, c)
        if loop["conditional_branches"] >= cells:
            raise AssertionError(f"K5 C={c} w={wb}: {loop['conditional_branches']} conditional "
                                 f"branches in the row loop, {cells} band cells: guarded cells")
    record["fused_dtw_v1"] = {
        "name": "fused_dtw_v1", "route": "cuda",
        "source": "rustpotter_tpu_torch/csrc/fused_dtw_v1.cu",
        "replaces": "rustpotter_tpu/ops/fused_dtw.py:78", "launches": None,
        "max_abs_err": worst, "ms": None, "plain_ms": plain_ms, "bound_ms": None,
        "bound_by": None, "library_ms": None}


def probe_phase(dev, record):
    """V1-V6 (tools/fma_probe.py) against their plain versions: at reps = 16
    with S in {8, 32}, and at reps = 2000 in each of fma_probe's timed runs,
    where the plain version is timed too. The kernels' times come from the
    tools phase, which repeats those runs on the same inputs."""
    import torch

    from rustpotter_tpu_torch.tools import fma_probe

    x, s = fma_probe.inputs(dev)
    tiles = fma_probe.default_tiles(dev)
    worst, plain_ms = {}, {}

    def hold(name, reps, S):
        """Kernel against plain version; (plain ms, max |d| / |plain|)."""
        got = fma_probe.probe(name, x, s, reps, S, tiles)
        out = []
        ms = time_cuda(lambda: out.append(fma_probe.plain(name, x, s, reps, S)), samples=1,
                       per=1, warmup=0)
        want = out[0].expand_as(got)
        rtol = fma_probe.PROBE_RTOL[reps, S] if name in ("sload", "smemload") else 0.0
        torch.testing.assert_close(got, want, rtol=rtol, atol=0,
                                   msg=lambda m: f"{name} reps={reps} S={S}: {m}")
        d = (got - want).abs()
        worst[name] = max(worst.get(name, 0.0), float(d.max()))
        return ms, float((d / want.abs()).max())

    for name in fma_probe.KERNELS:
        for S in (8, 32):
            hold(name, 16, S)
    for label, name, S in fma_probe.RUNS:
        ms, rel = hold(name, fma_probe.REPS, S)
        plain_ms[name] = ms  # the run the kernels line reads is the last one of each probe
        log(f"probe {label}: matches its plain version at reps=16 (S=8 and 32) and at "
            f"reps={fma_probe.REPS}, S={S}: max|d| {worst[name]:.3e}, max|d|/|plain| at "
            f"reps={fma_probe.REPS} {rel:.3e}; plain {ms:.1f} ms")
    for name, (_, replaces) in fma_probe.KERNELS.items():
        record[f"fma_probe_{name}"] = {
            "name": f"fma_probe_{name}", "route": "cuda",
            "source": "rustpotter_tpu_torch/csrc/fma_probe.cu", "replaces": replaces,
            "launches": None, "max_abs_err": worst[name], "ms": None,
            "plain_ms": plain_ms[name], "bound_ms": None, "bound_by": None,
            "library_ms": None}


def tools_phase(dev, record):
    """The kernel tooling path: kernel_parity's seven checks at B=8192, the
    kernel probe in each of its 5 modes, the fp32 probes timed at reps=2000,
    and the host ingest library; counts reset before and read after."""
    import torch

    from rustpotter_tpu_torch import _build, native
    from rustpotter_tpu_torch.audio.encoder import decode_bytes
    from rustpotter_tpu_torch.config import Endianness, SampleFormat
    from rustpotter_tpu_torch.tools import fma_probe, kernel_parity, kernel_probe

    reset_counts()
    t0 = time.perf_counter()
    kernel_parity.run(BENCH_STREAMS, dev)
    log(f"tools: kernel_parity passed all {len(kernel_parity.CHECKS)} checks at "
        f"B={BENCH_STREAMS} in {time.perf_counter() - t0:.2f} s")
    probes = {}
    for argv in (["--v1"], ["--v2"], ["--v4"], ["--k3"], []):
        B, iters, variant, gate = kernel_probe.parse([str(BENCH_STREAMS), "20", *argv])
        probes[variant] = kernel_probe.measure(B, iters, variant, gate, dev)
        for line in kernel_probe.report(probes[variant]):
            log(f"kernel_probe {' '.join(argv) or '(default)'}: {line}")
    log(f"tools: K5 {probes[1]['ms']:.4f} ms beside K4 {probes[2]['ms']:.4f} ms on the same "
        "inputs")
    k4_wide = {}
    for w in K4_WIDE_BANDS:  # K4's column form at F1's bands and at 75 (--v2 --w=N)
        argv = [str(BENCH_STREAMS), "20", "--v2", f"--w={w}"]
        B, iters, variant, gate = kernel_probe.parse(argv)
        r = kernel_probe.measure(B, iters, variant, gate, dev, kernel_probe.band(argv))
        for line in kernel_probe.report(r):
            log(f"kernel_probe --v2 --w={w}: {line}")
        k4_wide[w] = dict(ms=r["ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          flops=r["flops"])
    rows, chip = fma_probe.measure(dev)
    loops = fma_probe.rep_loop_facts(fma_probe.sass_listing())
    probe_log = _build.build_log(fma_probe.SOURCE, {})
    for label, name in (("V3", "dynload"), ("V4", "dynload_cheap"), ("V5", "sload"),
                        ("V6", "smemload")):
        for S in (8, 32):
            # the mangled name: length-prefixed identifier, then <S>
            r = ptxas_resources(probe_log, f"{len(name) + 6}probe_{name}ILi{S}E")
            facts = loops[(name, S)]
            loop = facts["ops"]
            log(f"{label} {name} S={S}: {r['registers']} registers, {r['spill_bytes']} bytes "
                f"of spill stores (ptxas); SASS rep loop {dict(facts['full_ops'])}")
            # V5 reads s from shared memory in its loop, the others load nothing there
            banned = ("LDG", "LDL", "LDC") if name == "sload" else ("LDG", "LDL", "LDS", "LDC")
            if any(loop[op] for op in banned):
                raise AssertionError(f"{label} S={S}: the rep loop loads ({dict(loop)})")
            if name == "sload":
                want = fma_probe.sload_ffma_per_load(S)
                if not loop["LDS"] or loop["FFMA"] != want * loop["LDS"]:
                    raise AssertionError(f"V5 S={S}: the rep loop holds {loop['FFMA']} FFMAs "
                                         f"and {loop['LDS']} shared loads, not {want} per load")
    for r in rows:
        log(f"fma_probe {r['label']:10s} {r['ms'] * 1e3:10.1f} us  {r['steps_per_us']:12.1f} "
            f"steps/us  {r['flops_per_step']} FLOP/step  {r['tflops']:7.3f} TFLOP/s  SASS "
            f"{r['sass']}")
    log(f"fma_probe: measured fp32 FMA rate {chip.fp32_fma_tflops_measured:.3f} TFLOP/s "
        f"(V1, 32 chains) beside the data-sheet peak {chip.fp32_tflops:.0f} TFLOP/s")
    pcm = np.random.default_rng(1).integers(-32768, 32768, 4800).astype("<i2").tobytes()
    if not np.array_equal(native.decode_pcm(pcm, "i16"),
                          decode_bytes(pcm, SampleFormat.I16, Endianness.LITTLE)):
        raise AssertionError("native decode_pcm differs from the encoder")
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"tools: launches {launches}; native ingest library built and decodes exactly")
    if launches["fused_dtw_v1"] == 0:
        raise AssertionError("the tools phase did not launch K5")
    record["fused_dtw_v1"].update(launches=launches["fused_dtw_v1"], ms=probes[1]["ms"],
                                  bound_ms=probes[1]["bound_ms"],
                                  bound_by=probes[1]["bound_by"])
    for name in fma_probe.KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"the tools phase did not launch probe {name}")
        S = 32 if name == "fma" else fma_probe.STREAMS
        r = next(r for r in rows if r["probe"] == name and r["S"] == S)
        bound_ms, bound_by = bound(r["flops"], r["bytes"])
        record[f"fma_probe_{name}"].update(launches=launches[name], ms=r["ms"],
                                           bound_ms=bound_ms, bound_by=bound_by)
    return {"fp32_fma_tflops_measured": chip.fp32_fma_tflops_measured,
            "k4_column_probe": k4_wide}


# ---------------------------------------------------------------- slice

def _counts():
    from rustpotter_tpu_torch.ops import banded_dtw as bd
    from rustpotter_tpu_torch.ops import biquad, frontend
    from rustpotter_tpu_torch.ops import fused_dtw as fd
    from rustpotter_tpu_torch.tools import fma_probe

    return fd.LAUNCHES, bd.LAUNCHES, fma_probe.LAUNCHES, biquad.LAUNCHES, frontend.LAUNCHES


def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    for counts in _counts():
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {k: v for counts in _counts() for k, v in counts.items()}


def assert_launches(launches: dict, want: dict, what: str) -> None:
    """Raises unless the kernels that launched in `launches` (`read_counts()`)
    are exactly those of `want`, each as often: no other kernel ran."""
    got = {k: v for k, v in launches.items() if v}
    assert got == {k: v for k, v in want.items() if v}, (what, got, want)


def batched_front(n: int) -> dict:
    """The MFCC front-end's launches in n batched chunks: csrc/mfcc_front.cu's
    prologue and epilogue once a chunk."""
    return {"mfcc_prologue": n, "mfcc_epilogue": n}


def step_front(n: int) -> dict:
    """The MFCC front-end's launches in n chunks (or frames) of the per-shift
    step: the epilogue once a shift."""
    return {"mfcc_epilogue": 3 * n}


def timed_windows(process, states, noise, device_out=None):
    """Host-clock seconds of TIMED_WINDOWS windows of TIMED_CHUNKS chunks of
    noise through process(states, frames), after one warm-up chunk. With a
    list `device_out`, the device's seconds of each window (CUDA events
    recorded at its start and end) are appended to it."""
    import torch

    states, _ = process(states, noise)
    windows = []
    for _ in range(TIMED_WINDOWS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(TIMED_CHUNKS):
            states, _ = process(states, noise)
        b.record()
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t0)
        if device_out is not None:
            device_out.append(a.elapsed_time(b) / 1e3)
    return states, windows


def run_pass(process, states, stream0, noise):
    """Bench correctness pass through process(states, frames) -> (states,
    Event): stream 0 plays `stream0`, the rest noise. Returns the events of
    every stream, stacked (T, B, ...) where they were computed."""
    import torch

    evs = []
    for t in range(stream0.shape[0]):
        frames = noise.clone()
        frames[0] = stream0[t]
        states, ev = process(states, frames)
        evs.append(ev)
    return [torch.stack(f) for f in zip(*evs)]


def run_correctness(process, states, stream0, noise):
    """`run_pass`, the events of streams 0-3 per chunk (numpy, (T, 4, ...))."""
    return [f[:, :4].cpu().numpy() for f in run_pass(process, states, stream0, noise)]


def bits_equal(a, b) -> bool:
    """The same bits (a NaN equals the same NaN; the gain is NaN with the
    gain normalizer off)."""
    import torch

    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def match_graph(got, want, got_states, want_states, what, rtol, atol) -> bool:
    """Raises unless a graphed run's events of every stream equal the eager
    run's (fired, ww, counter exactly; scores, avg scores, gains where an
    event fired within (rtol, atol)) and, unless they are None, its final
    states the eager run's (integers exactly, floats within (rtol, atol),
    the window's MFCC rows within the CPU tests' rtol 1e-5 / atol 1e-4).
    Returns whether every bit is equal, NaNs included."""
    import torch

    from rustpotter_tpu_torch.runtime.state import StreamState

    for j, name in ((0, "fired"), (1, "ww"), (4, "counter")):
        assert torch.equal(got[j], want[j]), f"{what}: event {name}, graph vs eager"
    fired = want[0]
    same = True
    for j, name in ((2, "score"), (3, "avg_score"), (5, "gain"), (6, "scores")):
        torch.testing.assert_close(got[j][fired], want[j][fired], rtol=rtol, atol=atol,
                                   equal_nan=True, msg=f"{what}: event {name}, graph vs eager")
        same &= bits_equal(got[j], want[j])
    for name, a, b in zip(StreamState._fields, got_states or (), want_states or ()):
        if a.dtype.is_floating_point:
            tol = (1e-5, 1e-4) if name == "win" else (rtol, atol)
            torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1], equal_nan=True,
                                       msg=f"{what}: state {name}, graph vs eager")
        else:
            assert torch.equal(a, b), f"{what}: state {name}, graph vs eager"
        same &= bits_equal(a, b)
    return same


def graph_pass(what, graphed, eager, states_g, states_e, stream0, noise, rtol=EV_RTOL,
               atol=EV_ATOL):
    """The correctness pass through a graphed entry point and through the
    eager function, each on its own states: the launches counted per replay
    must equal the eager run's, `match_graph` must hold, and the replays
    must run the kernels counted (`replays_run`). Returns the graphed run's
    events of streams 0-3 (numpy, as run_correctness), its launches, and
    whether graph and eager agree bit for bit."""
    import torch

    reset_counts()
    got = run_pass(graphed, states_g, stream0, noise)
    torch.cuda.synchronize()
    launches = read_counts()
    reset_counts()
    want = run_pass(eager, states_e, stream0, noise)
    torch.cuda.synchronize()
    eager_launches = read_counts()
    assert launches == eager_launches, (what, launches, eager_launches)
    same = match_graph(got, want, states_g, states_e, what, rtol, atol)
    log(f"{what}: graphed events equal the eager function's on all {got[0].shape[1]} streams "
        f"({int(want[0].sum())} events; scores and states within rtol {rtol} / atol {atol}); "
        f"bit-equal {same}; launches per replay as eager: "
        f"{ {k: v for k, v in launches.items() if v} }")
    # the profiled calls leave the states as the pass left them: callers read them
    saved = [[t.clone() for t in states] for states in (states_g, states_e)]
    replays_run(what, lambda: graphed(states_g, noise), lambda: eager(states_e, noise),
                launches, stream0.shape[0])
    for states, copies in zip((states_g, states_e), saved):
        for t, c in zip(states, copies):
            t.copy_(c)
    return [f[:, :4].cpu().numpy() for f in got], launches, same


def replays_run(what, graphed, eager, launches, n):
    """Raises unless torch.profiler (CUPTI) sees a call of `graphed` (a
    replay) run each of the port's kernels as often as a call of `eager`
    does, and the kernels that the wrappers' counts (`launches` over n
    calls, derived from the capture) name: the graph holds the kernels it
    is counted for. K1 and K2 launch twice per wrapper call when a chunk
    holds both ungated and gated templates. Each side is the median of
    REPLAY_READINGS profiles of PROFILED_CHUNKS calls, rounded to whole
    launches per call (`profiled_launches`); the totals count the device
    kernels and copies, the graphed call's copies outside the graph among them.
    Returns the totals per replay and per eager call."""
    t0 = time.perf_counter()
    got, total_g = profiled_launches(graphed, PROFILED_CHUNKS, readings=REPLAY_READINGS)
    want, total_e = profiled_launches(eager, PROFILED_CHUNKS, readings=REPLAY_READINGS)
    REPLAY_PROFILES["paths"] += 1
    REPLAY_PROFILES["s"] += time.perf_counter() - t0
    counted = {k: v / n for k, v in launches.items() if v}
    assert got == want and set(got) == set(counted), (what, got, want, counted)
    assert all(got[k] >= counted[k] for k in got), (what, got, counted)
    log(f"{what}: profiled, a replay runs {total_g:.1f} device kernels and copies, an eager "
        f"call {total_e:.1f}; the port's kernels per call {got} in both (counted per wrapper "
        f"call {counted})")
    return total_g, total_e


def eager_graph_turns(what, card, eager, graphed, make_states, noise):
    """Host ms per chunk of `eager` and of `graphed` (process(states, frames)),
    in turns eager, graph, graph, eager, each the median of TIMED_WINDOWS
    windows of TIMED_CHUNKS chunks from fresh states (its first chunk
    captures the graph); and the graph's device ms per chunk, the median of
    its windows' CUDA-event spans (the replays with their input and output
    copies)."""
    ms = {"eager": [], "graph": []}
    windows = {"eager": [], "graph": []}
    device = []
    for which in ("eager", "graph", "graph", "eager"):
        _, w = timed_windows(eager if which == "eager" else graphed, make_states(), noise,
                             device if which == "graph" else None)
        ms[which].append(float(np.median(w)) / TIMED_CHUNKS * 1e3)
        windows[which] += w
    device_ms = float(np.median(device)) / TIMED_CHUNKS * 1e3
    rt = lambda m: noise.shape[0] * 0.03 / (m / 1e3)
    log(f"{what} [{card}]: host ms per chunk in turns eager {ms['eager'][0]:.4f} / graph "
        f"{ms['graph'][0]:.4f} / graph {ms['graph'][1]:.4f} / eager {ms['eager'][1]:.4f} "
        f"(streams_rt {rt(ms['eager'][0]):.1f} / {rt(ms['graph'][0]):.1f} / "
        f"{rt(ms['graph'][1]):.1f} / {rt(ms['eager'][1]):.1f}); the graph's device time "
        f"{device_ms:.4f} ms per chunk (CUDA events around the graph's windows of replays)")
    return ms, windows, device_ms


def match_events(gpu, cpu, what, rtol=EV_RTOL, atol=EV_ATOL):
    """Raises unless the card's events of streams 0-3 equal the CPU run's:
    fired, ww and counter exactly, scores within (rtol, atol) where an
    event fired. Returns (events, max |d| of the scores)."""
    for j, name in ((0, "fired"), (1, "ww"), (4, "counter")):
        np.testing.assert_array_equal(gpu[j], cpu[j], err_msg=f"{what}: event {name}, card vs cpu")
    fired = cpu[0]
    worst = 0.0
    for j, name in ((2, "score"), (3, "avg_score"), (6, "scores")):
        np.testing.assert_allclose(gpu[j][fired], cpu[j][fired], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: event {name}, card vs cpu")
        if fired.any():
            worst = max(worst, float(np.abs(gpu[j][fired] - cpu[j][fired]).max()))
    return int(fired.sum()), worst


def match_detections(gpu_dets, cpu_dets, what, rtol=EV_RTOL, atol=EV_ATOL):
    """Raises unless two single-stream runs detect at the same frames with
    the same name, counter, gain and scores. Returns max |d| of the scores."""
    assert [i for i, _ in gpu_dets] == [i for i, _ in cpu_dets], what
    worst = 0.0
    for (_, g), (_, c) in zip(gpu_dets, cpu_dets):
        assert (g.name, g.counter, g.gain, list(g.scores)) == (
            c.name, c.counter, c.gain, list(c.scores)), (what, g, c)
        gv = np.array([g.score, g.avg_score, *g.scores.values()])
        cv = np.array([c.score, c.avg_score, *c.scores.values()])
        np.testing.assert_allclose(gv, cv, rtol=rtol, atol=atol, err_msg=what)
        worst = max(worst, float(np.abs(gv - cv).max()))
    return worst


def slice_phase(dev, record):
    import torch

    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk
    from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

    B, T = BENCH_STREAMS, TIMED_CHUNKS
    ww, utterance = build_bench_wakeword(device=dev)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev)
    rng = np.random.default_rng(0)
    noise_np = rng.normal(0, 0.05, (B, 480)).astype(np.float32)
    noise = torch.tensor(noise_np, device=dev)
    stream0_np = correctness_stream(det.static.max_mfcc_frames, utterance)
    stream0 = torch.tensor(stream0_np, device=dev)
    n_chunks = stream0_np.shape[0]

    eager = make_batched_chunk(det.static)
    gpu, launches, same = graph_pass(
        "slice", lambda s, f: det.process_chunk(det.params, s, f),
        lambda s, f: eager(det.params, s, f), det.init_states(), det.init_states(), stream0,
        noise)
    fired0 = int(gpu[0][:, 0].sum())
    log(f"slice: correctness pass {n_chunks} chunks at B={B} through the graphed "
        f"process_chunk, stream 0 fired {fired0}x, K1 launches {launches['fused_dtw_v4']}")
    assert fired0 >= 1, "correctness guard: the bench wakeword did not fire on stream 0"
    assert_launches(launches, {"fused_dtw_v4": n_chunks, **batched_front(n_chunks)}, "slice")
    record["fused_dtw_v4"]["launches"] = launches["fused_dtw_v4"]

    # process_sequence: the pass in one call, T replays; the same bits
    frames = noise.expand(n_chunks, B, 480).clone()
    frames[:, 0] = stream0
    reset_counts()
    _, seq = det.process_sequence(det.params, det.init_states(), frames)
    torch.cuda.synchronize()
    seq_launches = read_counts()
    k1_seq = seq_launches["fused_dtw_v4"]
    del frames
    for got, want in zip(seq, gpu):
        assert bits_equal(got[:, :4].cpu(), torch.from_numpy(want)), "process_sequence"
    assert_launches(seq_launches, {"fused_dtw_v4": n_chunks, **batched_front(n_chunks)},
                    "slice process_sequence")
    log(f"slice: process_sequence of the {n_chunks} chunks gives the graphed process_chunk's "
        f"events of streams 0-3 bit for bit; K1 launches {k1_seq}")

    cpu_det = BatchedDetector([("w", ww)], cfg, batch_size=4, device="cpu")
    cpu = run_correctness(lambda s, f: cpu_det.process_chunk(cpu_det.params, s, f),
                          cpu_det.init_states(), torch.tensor(stream0_np),
                          torch.tensor(noise_np[:4]))
    n_events, worst = match_events(gpu, cpu, "batched")
    log(f"slice: streams 0-3 match the cpu run at B=4 ({n_events} events, "
        f"max|d score| {worst:.3e})")

    t, rows, _ = chunk_timing(det, noise, "slice", card_line())
    k1_ms = sum(r[0] for r in rows if "score_pairs" in r[2])
    log(f"slice: {t['streams_rt']:.1f} realtime streams graphed, median of "
        f"{2 * TIMED_WINDOWS} windows (range {t['streams_rt_min']:.1f}-{t['streams_rt_max']:.1f}; "
        f"B={B}, {T} chunks per window, {t['chunk_ms']:.4f} ms/chunk host clock); eager "
        f"{t['eager_streams_rt']:.1f} ({t['eager_chunk_ms']:.4f} ms/chunk)")
    if not rows:
        log("slice: the profiler recorded no device time: the breakdown is not measured")
    else:
        log(f"slice: device kernels per eager chunk {t['kernel_ms']:.4f} ms in "
            f"{sum(r[1] for r in rows):.1f} launches of {len(rows)} kernels: front-end "
            f"{t['front_ms']:.4f} ms, K1 {k1_ms:.4f} ms, rest "
            f"{t['kernel_ms'] - t['front_ms'] - k1_ms:.4f} ms; device idle "
            f"{100 * (1 - t['kernel_ms'] / t['eager_chunk_ms']):.1f} % of the eager host clock, "
            f"{100 * (1 - t['kernel_ms'] / t['chunk_ms']):.1f} % of the graph's")
    for ms, count, name in rows[:PROFILE_ROWS]:
        log(f"profile: {ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  {name[:110]}")
    return {**t, "k1_chunk_ms": k1_ms, "launches_per_chunk": sum(r[1] for r in rows),
            "slice_graph_bit_equal": same}


def chunk_timing(det, noise, what, card):
    """det's chunk on `noise` (B, input_samples) on the card: the host clock
    of the graphed process_chunk against the eager chunk
    (make_batched_chunk) in turns (`eager_graph_turns`: streams_rt of the
    graph's median window over both graph turns, and its range; the median
    window is kept, since the host clock spreads between windows), the
    graph's device ms by CUDA events, and torch.profiler's (CUPTI) device
    kernel rows of the eager chunk and of its front-end alone, where the
    profile's launch counts are the chunk's. Returns (the summary; rows;
    front rows)."""
    from rustpotter_tpu_torch.ops import frontend
    from rustpotter_tpu_torch.runtime.stream_step import filter_chunk, make_batched_chunk

    B, T, C = noise.shape[0], TIMED_CHUNKS, det.static.mfcc_size
    eager = make_batched_chunk(det.static)
    ms, windows, device_ms = eager_graph_turns(
        what, card, lambda s, f: eager(det.params, s, f),
        lambda s, f: det.process_chunk(det.params, s, f), det.init_states, noise)
    states = det.init_states()

    def front():
        st, samples = filter_chunk(det.static, det.params, states, noise)
        unfiltered = not (det.static.gain_enabled or det.static.bp_enabled)
        frames3, _ = frontend.prologue(samples, st.ext_buf, rms=unfiltered)
        return frontend.mfcc_from_frames(frames3, C + 1, window=True)

    rows = device_kernels(lambda: eager(det.params, states, noise), PROFILED_CHUNKS)
    front_rows = device_kernels(front, PROFILED_CHUNKS)
    audio_s = B * T * 0.03
    gw, ew = windows["graph"], windows["eager"]
    return ({"streams_rt": audio_s / float(np.median(gw)),
             "streams_rt_min": audio_s / max(gw), "streams_rt_max": audio_s / min(gw),
             "chunk_ms": float(np.median(gw)) / T * 1e3,
             "eager_streams_rt": audio_s / float(np.median(ew)),
             "eager_chunk_ms": float(np.median(ew)) / T * 1e3,
             "eager_ms_turns": ms["eager"], "graph_ms_turns": ms["graph"],
             "graph_device_ms": device_ms,
             "kernel_ms": sum(r[0] for r in rows), "front_ms": sum(r[0] for r in front_rows)},
            rows, front_rows)


# ------------------------------------------------------- per-shift slice

def play_single_stream(rp, frames):
    """Detections [(frame index, RustpotterDetection)] and host seconds per
    process_samples call."""
    dets, secs = [], []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        d = rp.process_samples(frame)
        secs.append(time.perf_counter() - t0)
        if d is not None:
            dets.append((i, d))
    return dets, secs


class EagerSingleStream:
    """The graphed Rustpotter's yardstick: Rustpotter.process_samples' frame
    loop (the host encoder, the step at B = 1, the read of `fired`) over the
    eager step `make_step(static)`, built from the same wakewords and
    config. process_samples returns the frame's Event (on the host) where it
    fired, else None."""

    def __init__(self, cfg, dev, wakewords):
        from rustpotter_tpu_torch.audio.encoder import AudioEncoder
        from rustpotter_tpu_torch.runtime.bundle import build_bundle
        from rustpotter_tpu_torch.runtime.stream_step import make_step

        self.wakewords, self.device = dict(wakewords), dev
        self.static, self.params = build_bundle(list(wakewords), cfg, dev)
        self.step, self.encoder = make_step(self.static), AudioEncoder(cfg.fmt)
        self.reset()

    def reset(self):
        from rustpotter_tpu_torch.runtime.state import init_state

        self.state = init_state(self.static, 1, self.device)
        self.encoder.reset()

    def process_samples(self, samples):
        import torch

        frame = self.encoder.rencode_and_resample(np.asarray(samples))
        x = torch.as_tensor(np.asarray(frame, np.float32), device=self.device).reshape(1, -1)
        self.state, ev = self.step(self.params, self.state, x)
        return type(ev)(*[f[0].cpu() for f in ev]) if bool(ev.fired[0]) else None

    def detection_of(self, ev):
        """(name, score labels) that Rustpotter decodes an Event to."""
        from rustpotter_tpu_torch.wakewords.files import WakewordRef

        st, ww = self.static, int(ev.ww)
        if isinstance(self.wakewords[st.names[ww]], WakewordRef):
            return self.wakewords[st.names[ww]].name, list(st.dtw_template_names[ww])
        labels = list(st.nn_meta[ww - st.n_dtw].labels)
        return labels[int(np.argmax(ev.scores[: len(labels)].numpy()))], labels


def single_streams(cfg, dev, wakewords):
    """(a Rustpotter over `wakewords` on the card (graphed), its eager
    yardstick `EagerSingleStream` on the card, a Rustpotter on the CPU)."""
    from rustpotter_tpu_torch import Rustpotter

    rps = []
    for d in (dev, "cpu"):
        rp = Rustpotter(cfg, device=d)
        for name, ww in wakewords:
            rp.add_wakeword(name, ww)
        rps.append(rp)
    return rps[0], EagerSingleStream(cfg, dev, wakewords), rps[1]


def rustpotter_graph_vs_eager(what, rp, eager, frames, rtol=EV_RTOL, atol=EV_ATOL):
    """The graphed Rustpotter against its eager yardstick over `frames`:
    detections at the frames where the eager step fires, with its name,
    counter, gain (bits) and scores; the same launches; and the kernels a
    replay runs (`replays_run`). Returns (detections, host seconds per call,
    launches, whether the scores are bit-equal)."""
    reset_counts()
    dets, secs = play_single_stream(rp, frames)
    launches = read_counts()
    reset_counts()
    fired, _ = play_single_stream(eager, frames)
    assert read_counts() == launches, (what, launches)
    assert [i for i, _ in dets] == [i for i, _ in fired], (what, dets, fired)
    worst = 0.0
    for (_, d), (_, ev) in zip(dets, fired):
        name, labels = eager.detection_of(ev)
        assert (d.name, d.counter, list(d.scores)) == (name, int(ev.counter), labels), (what, d)
        assert np.float32(d.gain).view(np.uint32) == ev.gain.numpy().view(np.uint32), (what, d)
        got = np.array([d.score, d.avg_score, *d.scores.values()])
        want = np.array([float(ev.score), float(ev.avg_score),
                         *ev.scores[: len(labels)].tolist()])
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"{what}: graphed detections equal the eager step's (frames "
        f"{[i for i, _ in dets]}, max|d score| {worst:.3e}, bit-equal {worst == 0.0})")
    frame = frames[len(frames) // 2]
    replays_run(what, lambda: rp.process_samples(frame), lambda: eager.process_samples(frame),
                launches, len(frames))
    rp.reset()
    eager.reset()
    return dets, secs, launches, worst == 0.0


def rustpotter_turns(what, card, rp, rp_eager, frames):
    """ms per process_samples (median over `frames`) of the eager yardstick
    and the graphed Rustpotter in turns eager, graph, graph, eager, each
    from a reset."""
    ms = {"eager": [], "graph": []}
    for which in ("eager", "graph", "graph", "eager"):
        r = rp_eager if which == "eager" else rp
        r.reset()
        ms[which].append(float(np.median(play_single_stream(r, frames)[1])) * 1e3)
    log(f"{what} [{card}]: ms per process_samples in turns eager {ms['eager'][0]:.4f} / graph "
        f"{ms['graph'][0]:.4f} / graph {ms['graph'][1]:.4f} / eager {ms['eager'][1]:.4f} "
        f"(medians of {len(frames)} frames, host clock)")
    return ms


def per_shift_phase(dev, record):
    """The single-stream Rustpotter and make_step at B=8192, in each of the
    three DTW kernel modes, against device="cpu" runs."""
    import dataclasses

    import torch

    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.runtime.bundle import build_bundle
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.state import init_state
    from rustpotter_tpu_torch.runtime.stream_step import make_step
    from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

    B = BENCH_STREAMS
    ww, utterance = build_bench_wakeword(device=dev)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2

    # (a) one stream through the public API, K2 (the default mode): the
    # graphed step against the eager one and the cpu run
    rp, rp_eager, rp_cpu = single_streams(cfg, dev, [("w", ww)])
    frames_np = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    n = len(frames_np)
    gpu_dets, secs, launches, rp_same = rustpotter_graph_vs_eager("Rustpotter", rp, rp_eager,
                                                                  frames_np)
    cpu_dets, _ = play_single_stream(rp_cpu, frames_np)
    log(f"per-shift: Rustpotter on the card fired at frames {[i for i, _ in gpu_dets]}, "
        f"the cpu run at {[i for i, _ in cpu_dets]}; K2 launches {launches['fused_dtw_v3']} "
        f"for {n} frames")
    assert gpu_dets, "correctness guard: the single-stream Rustpotter did not fire"
    assert_launches(launches, {"fused_dtw_v3": 3 * n, **step_front(n)}, "Rustpotter")
    worst = match_detections(gpu_dets, cpu_dets, "Rustpotter")
    rp_ms = float(np.median(secs)) * 1e3
    log(f"per-shift: Rustpotter detections match the cpu run (max|d score| {worst:.3e}); "
        f"{rp_ms:.4f} ms per process_audio, median of {n} (range "
        f"{min(secs) * 1e3:.4f}-{max(secs) * 1e3:.4f}) host clock")
    # process_audio_sequence: one replay per frame, the events read once
    rp.reset()
    reset_counts()
    seq = rp.process_audio_sequence(frames_np.reshape(-1))
    assert read_counts()["fused_dtw_v3"] == 3 * n
    match_detections(list(enumerate(seq)), list(enumerate(d for _, d in gpu_dets)),
                     "Rustpotter process_audio_sequence")
    log(f"per-shift: Rustpotter.process_audio_sequence gives the {len(seq)} detections of the "
        f"frame loop")
    rp_turns = rustpotter_turns("Rustpotter", card_line(), rp, rp_eager, frames_np)

    # (b) make_step at B=8192 in each mode, streams 0-3 against a cpu run
    rng = np.random.default_rng(0)
    noise_np = rng.normal(0, 0.05, (B, 480)).astype(np.float32)
    noise = torch.tensor(noise_np, device=dev)
    stream0 = torch.tensor(frames_np, device=dev)
    static, params = build_bundle([("w", ww)], cfg, dev)
    _, params_cpu = build_bundle([("w", ww)], cfg, "cpu")
    modes = (("fused_dtw_v3", static),
             ("fused_dtw_v2", dataclasses.replace(static, dtw_fused_variant=2)),
             ("banded_dtw", dataclasses.replace(static, dtw_fused=False)))
    summary = {"rp_ms": rp_ms, "rp_ms_min": min(secs) * 1e3, "rp_ms_max": max(secs) * 1e3,
               "rp_eager_ms_turns": rp_turns["eager"], "rp_graph_ms_turns": rp_turns["graph"],
               "rp_graph_bit_equal": rp_same}
    for name, st in modes:
        step, eager = GraphedStep(make_step(st)), make_step(st)
        gpu, launches, same = graph_pass(
            f"per-shift {name}", lambda s, f: step(params, s, f),
            lambda s, f: eager(params, s, f), init_state(st, B, dev), init_state(st, B, dev),
            stream0, noise)
        fired0 = int(gpu[0][:, 0].sum())
        log(f"per-shift {name}: correctness pass {n} chunks at B={B} through the graphed step, "
            f"stream 0 fired {fired0}x, launches {launches}")
        assert fired0 >= 1, f"correctness guard: stream 0 did not fire in mode {name}"
        assert_launches(launches, {name: 3 * n, **step_front(n)}, f"per-shift {name}")
        record[name]["launches"] = launches[name]
        cpu_step = make_step(st)
        cpu = run_correctness(lambda s, f: cpu_step(params_cpu, s, f), init_state(st, 4, "cpu"),
                              torch.tensor(frames_np), torch.tensor(noise_np[:4]))
        n_events, worst = match_events(gpu, cpu, name)
        log(f"per-shift {name}: streams 0-3 match the cpu run at B=4 ({n_events} events, "
            f"max|d score| {worst:.3e})")
        summary[f"{name}_graph_bit_equal"] = same

    # (c) the K2 mode on the host clock, graphed against eager in turns, and
    # the eager step's device time by kernel
    step, graphed = make_step(static), GraphedStep(make_step(static))
    turns, windows, graph_device_ms = eager_graph_turns(
        "per-shift K2 mode", card_line(), lambda s, f: step(params, s, f),
        lambda s, f: graphed(params, s, f), lambda: init_state(static, B, dev), noise)
    states = init_state(static, B, dev)
    elapsed = float(np.median(windows["graph"]))
    chunk_ms = elapsed / TIMED_CHUNKS * 1e3
    streams_rt = B * TIMED_CHUNKS * 0.03 / elapsed
    rt_range = (B * TIMED_CHUNKS * 0.03 / max(windows["graph"]),
                B * TIMED_CHUNKS * 0.03 / min(windows["graph"]))
    eager_ms = float(np.median(windows["eager"])) / TIMED_CHUNKS * 1e3
    rows = device_kernels(lambda: step(params, states, noise), PROFILED_CHUNKS)
    kernel_ms = sum(r[0] for r in rows)
    k2_ms = sum(r[0] for r in rows if "score_pairs_v3" in r[2])
    gemm_ms = sum(r[0] for r in rows if "gemm" in r[2].lower())
    log(f"per-shift K2 mode: {streams_rt:.1f} realtime streams graphed, median of "
        f"{2 * TIMED_WINDOWS} windows (range {rt_range[0]:.1f}-{rt_range[1]:.1f}; B={B}, "
        f"{TIMED_CHUNKS} chunks per window, {chunk_ms:.4f} ms/chunk host clock); eager "
        f"{eager_ms:.4f} ms/chunk")
    if not rows:
        log("per-shift: the profiler recorded no device time: the breakdown is not measured")
    else:
        log(f"per-shift K2 mode: device kernels per eager chunk {kernel_ms:.4f} ms in "
            f"{sum(r[1] for r in rows):.1f} launches of {len(rows)} kernels: K2 {k2_ms:.4f} ms, "
            f"GEMMs {gemm_ms:.4f} ms, rest {kernel_ms - k2_ms - gemm_ms:.4f} ms; device idle "
            f"{100 * (1 - kernel_ms / eager_ms):.1f} % of the eager host clock, "
            f"{100 * (1 - kernel_ms / chunk_ms):.1f} % of the graph's")
    for ms, count, kname in rows[:PROFILE_ROWS]:
        log(f"profile step: {ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  {kname[:110]}")
    summary.update({"step_streams_rt": streams_rt, "step_streams_rt_min": rt_range[0],
                    "step_streams_rt_max": rt_range[1], "step_chunk_ms": chunk_ms,
                    "step_eager_chunk_ms": eager_ms, "step_eager_ms_turns": turns["eager"],
                    "step_graph_ms_turns": turns["graph"],
                    "step_graph_device_ms": graph_device_ms,
                    "step_kernel_ms": kernel_ms, "step_k2_ms": k2_ms,
                    "step_launches_per_chunk": sum(r[1] for r in rows)})

    # (d) the K3 mode (band costs + K3) likewise: K3's device time per chunk
    # beside the rest, and the host clock, which the enqueue bounds
    st3 = modes[2][1]
    step3 = make_step(st3)
    states3, windows3 = timed_windows(lambda s, f: step3(params, s, f), init_state(st3, B, dev),
                                      noise)
    chunk3_ms = float(np.median(windows3)) / TIMED_CHUNKS * 1e3
    rows3 = device_kernels(lambda: step3(params, states3, noise), PROFILED_CHUNKS)
    kernel3_ms = sum(r[0] for r in rows3)
    k3_ms = sum(r[0] for r in rows3 if "banded_dp" in r[2])
    log(f"per-shift K3 mode: {chunk3_ms:.4f} ms/chunk host clock (median of {TIMED_WINDOWS} "
        f"windows of {TIMED_CHUNKS} chunks, range {min(windows3) / TIMED_CHUNKS * 1e3:.4f}-"
        f"{max(windows3) / TIMED_CHUNKS * 1e3:.4f})")
    if rows3:
        log(f"per-shift K3 mode: device kernels per chunk {kernel3_ms:.4f} ms in "
            f"{sum(r[1] for r in rows3):.1f} launches of {len(rows3)} kernels: K3 {k3_ms:.4f} "
            f"ms, rest {kernel3_ms - k3_ms:.4f} ms; beside the K2 mode's K2 {k2_ms:.4f} ms of "
            f"{kernel_ms:.4f} ms")
    for ms, count, kname in rows3[:PROFILE_ROWS]:
        log(f"profile step K3 mode: {ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  "
            f"{kname[:110]}")
    summary.update({"step3_chunk_ms": chunk3_ms, "step3_kernel_ms": kernel3_ms,
                    "step3_k3_ms": k3_ms})

    # (e) the K4 mode: K4's device time per chunk beside the K2 mode's K2
    st4 = modes[1][1]
    step4 = make_step(st4)
    states4 = init_state(st4, B, dev)
    rows4 = device_kernels(lambda: step4(params, states4, noise), PROFILED_CHUNKS)
    kernel4_ms = sum(r[0] for r in rows4)
    k4_ms = sum(r[0] for r in rows4 if "score_pairs_v2" in r[2])
    if rows4:
        log(f"per-shift K4 mode: device kernels per chunk {kernel4_ms:.4f} ms in "
            f"{sum(r[1] for r in rows4):.1f} launches of {len(rows4)} kernels: K4 {k4_ms:.4f} "
            f"ms, rest {kernel4_ms - k4_ms:.4f} ms; beside the K2 mode's K2 {k2_ms:.4f} ms")
    summary.update({"step4_kernel_ms": kernel4_ms, "step4_k4_ms": k4_ms})
    return summary


# ------------------------------------------------------------------- NN

def nn_cell(dev, card, name, correct_ww, timed_ww, stream0_np, noise_np, cfg):
    """One NN cell of BatchedDetector at B=8192: the correctness pass with
    `correct_ww` (stream 0 must fire, streams 0-3 must give a device="cpu"
    run's events at B=4, K1 must launch once per chunk with a DTW wakeword
    and never without), then `timed_ww` (the same shapes) on the host clock
    and split by torch.profiler into front-end, NN GEMMs, K1 and the rest."""
    import torch

    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk
    from rustpotter_tpu_torch.utils.profiling import step_roofline

    B = BENCH_STREAMS
    noise = torch.tensor(noise_np, device=dev)
    det = BatchedDetector(correct_ww, cfg, batch_size=B, device=dev)
    n = stream0_np.shape[0]
    eager = make_batched_chunk(det.static)
    gpu, launches, same = graph_pass(
        name, lambda s, f: det.process_chunk(det.params, s, f),
        lambda s, f: eager(det.params, s, f), det.init_states(), det.init_states(),
        torch.tensor(stream0_np, device=dev), noise, NN_RTOL, NN_ATOL)
    fired0 = int(gpu[0][:, 0].sum())
    want_k1 = n if det.static.n_dtw else 0
    log(f"{name}: correctness pass {n} chunks at B={B}, stream 0 fired {fired0}x, launches "
        f"{launches}")
    assert fired0 >= 1, f"correctness guard: {name} did not fire on stream 0"
    assert_launches(launches, {"fused_dtw_v4": want_k1, **batched_front(n)}, name)
    cpu_det = BatchedDetector(correct_ww, cfg, batch_size=4, device="cpu")
    cpu = run_correctness(lambda s, f: cpu_det.process_chunk(cpu_det.params, s, f),
                          cpu_det.init_states(), torch.tensor(stream0_np),
                          torch.tensor(noise_np[:4]))
    n_events, worst = match_events(gpu, cpu, name, NN_RTOL, NN_ATOL)
    log(f"{name}: streams 0-3 match the cpu run at B=4 ({n_events} events, max|d score| "
        f"{worst:.3e})")

    det = BatchedDetector(timed_ww, cfg, batch_size=B, device=dev)
    t, rows, front_rows = chunk_timing(det, noise, name, card)
    gemm = lambda rs: sum(r[0] for r in rs if "gemm" in r[2].lower())
    nn_ms = gemm(rows) - gemm(front_rows)
    k1_ms = sum(r[0] for r in rows if "score_pairs" in r[2])
    rest_ms = t["kernel_ms"] - t["front_ms"] - nn_ms - k1_ms
    gflop = step_roofline(det.static).gemm_flops * B / 1e9
    log(f"{name} [{card}]: {t['streams_rt']:.1f} realtime streams graphed, median of "
        f"{2 * TIMED_WINDOWS} windows (range {t['streams_rt_min']:.1f}-{t['streams_rt_max']:.1f}; "
        f"B={B}, {TIMED_CHUNKS} chunks per window, {t['chunk_ms']:.4f} ms/chunk host clock; eager "
        f"{t['eager_chunk_ms']:.4f}); {gflop:.2f} GFLOP of products per chunk (step_roofline)")
    if not rows:
        log(f"{name}: the profiler recorded no device time: the breakdown is not measured")
    else:
        log(f"{name} [{card}]: device kernels per eager chunk {t['kernel_ms']:.4f} ms in "
            f"{sum(r[1] for r in rows):.1f} launches of {len(rows)} kernels: front-end "
            f"{t['front_ms']:.4f} ms, NN GEMMs {nn_ms:.4f} ms, K1 {k1_ms:.4f} ms, rest "
            f"{rest_ms:.4f} ms; device idle "
            f"{100 * (1 - t['kernel_ms'] / t['eager_chunk_ms']):.1f} % of the eager host clock, "
            f"{100 * (1 - t['kernel_ms'] / t['chunk_ms']):.1f} % of the graph's")
    for ms, count, kname in rows[:PROFILE_ROWS]:
        log(f"profile {name}: {ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  {kname[:110]}")
    return {f"{name}_{k}": v for k, v in {**t, "nn_gemm_ms": nn_ms, "k1_ms": k1_ms,
                                           "graph_bit_equal": same}.items()}


def nn_phase(dev, card, record):
    """NN wakewords, the F1 bands and wakeword management on the card (see
    the module docstring, phase 6)."""
    import copy
    from functools import partial

    import torch

    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.ops import fused_dtw as fd
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.bundle import build_bundle
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.state import init_state
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk, make_step
    from rustpotter_tpu_torch.synthetic import (
        build_bench_nn_wakeword,
        build_bench_wakeword,
        build_firing_nn_wakeword,
        correctness_stream,
    )

    B = BENCH_STREAMS
    ww, utterance = build_bench_wakeword(device=dev)
    firing = build_firing_nn_wakeword(utterance, device=dev)
    medium = build_bench_nn_wakeword()
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    noise_np = np.random.default_rng(0).normal(0, 0.05, (B, 480)).astype(np.float32)
    stream0_np = correctness_stream(firing.train_size, utterance)
    summary = {}
    # (a) nn_medium and (b) mixed at B=8192
    summary.update(nn_cell(dev, card, "nn_medium", [("n", firing)], [("n", medium)],
                           stream0_np, noise_np, cfg))
    summary.update(nn_cell(dev, card, "mixed", [("w", ww), ("n", firing)],
                           [("w", ww), ("n", medium)], stream0_np, noise_np, cfg))

    # (c) the single-stream Rustpotter with mixed: K2, 3 launches per frame
    rps = single_streams(cfg, dev, [("w", ww), ("n", firing)])
    gpu_dets, secs, launches, _ = rustpotter_graph_vs_eager("Rustpotter mixed", rps[0], rps[1],
                                                            stream0_np, NN_RTOL, NN_ATOL)
    cpu_dets, _ = play_single_stream(rps[2], stream0_np)
    n = len(stream0_np)
    assert gpu_dets, "correctness guard: Rustpotter with mixed did not fire"
    assert_launches(launches, {"fused_dtw_v3": 3 * n, **step_front(n)}, "Rustpotter mixed")
    worst = match_detections(gpu_dets, cpu_dets, "Rustpotter mixed", NN_RTOL, NN_ATOL)
    rp_ms = float(np.median(secs)) * 1e3
    log(f"Rustpotter mixed [{card}]: fired at frames {[i for i, _ in gpu_dets]} as "
        f"{[d.name for _, d in gpu_dets]}, as the cpu run (max|d score| {worst:.3e}); K2 "
        f"launches {launches['fused_dtw_v3']} for {n} frames; {rp_ms:.4f} ms per process_audio, "
        f"median of {n} host clock")
    summary["rp_mixed_ms"] = rp_ms

    # (d) F1: bands past K1's and K2's rings route to K4 (3 launches per
    # chunk or frame), on the short bench wakeword at a small B
    ww30, utt30 = build_bench_wakeword(device=dev, longest=30)
    small_b = 64
    paths = {  # (graphed, eager) of each path
        "BatchedDetector": lambda det: (lambda s, f: det.process_chunk(det.params, s, f),
                                        partial(make_batched_chunk(det.static), det.params)),
        "make_step": lambda det: (partial(GraphedStep(make_step(det.static)), det.params),
                                  partial(make_step(det.static), det.params)),
    }
    for band in (21, 24):
        cfg_b = copy.deepcopy(cfg)
        cfg_b.detector.band_size = band
        sizes = ((dev, small_b), ("cpu", 4))
        dets = {d: BatchedDetector([("w", ww30)], cfg_b, batch_size=b, device=d) for d, b in sizes}
        assert dets[dev].static.dtw_k4_for_band and dets[dev].static.dtw_fused_variant == 2
        s0 = correctness_stream(dets[dev].static.max_mfcc_frames, utt30)
        n = len(s0)
        for path, runner in paths.items():
            graphed, eager = runner(dets[dev])
            st = lambda d, b: init_state(dets[d].static, b, d)
            runs = {"cpu": run_correctness(runner(dets["cpu"])[1], st("cpu", 4),
                                           torch.tensor(s0), torch.tensor(noise_np[:4]))}
            runs[dev], launches, _ = graph_pass(
                f"F1 w={band} {path}", graphed, eager, st(dev, small_b), st(dev, small_b),
                torch.tensor(s0, device=dev), torch.tensor(noise_np[:small_b], device=dev))
            n_events, worst = match_events(runs[dev], runs["cpu"], f"F1 w={band} {path}")
            assert int(runs[dev][0][:, 0].sum()) >= 1, f"F1 w={band} {path}: stream 0 silent"
            front = batched_front(n) if path == "BatchedDetector" else step_front(n)
            assert_launches(launches, {"fused_dtw_v2": 3 * n, **front}, f"F1 w={band} {path}")
            log(f"F1 w={band} {path} at B={small_b}: {n} chunks, K4 launches "
                f"{launches['fused_dtw_v2']}, K1 {launches['fused_dtw_v4']}, K2 "
                f"{launches['fused_dtw_v3']}; streams 0-3 match the cpu run ({n_events} events, "
                f"max|d score| {worst:.3e})")
        rps = single_streams(cfg_b, dev, [("w", ww30)])
        gpu_dets, _, launches, _ = rustpotter_graph_vs_eager(f"F1 w={band} Rustpotter", rps[0],
                                                             rps[1], s0)
        cpu_dets, _ = play_single_stream(rps[2], s0)
        assert gpu_dets, f"F1 w={band} Rustpotter did not fire"
        worst = match_detections(gpu_dets, cpu_dets, f"F1 w={band} Rustpotter")
        assert_launches(launches, {"fused_dtw_v2": 3 * n, **step_front(n)},
                        f"F1 w={band} Rustpotter")
        log(f"F1 w={band} Rustpotter: fired at frames {[i for i, _ in gpu_dets]} as the cpu run "
            f"(max|d score| {worst:.3e}); K4 launches {launches['fused_dtw_v2']} for {n} frames")

    # (d') K4's column form at the bench's B, on the graphed make_step path: the
    # bench wakeword (Lm = 100) at F1's bands, the launches of the correctness
    # pass, the host clock and the graph's device time (one turn), and K4's
    # device time per chunk by torch.profiler over the eager step
    noise_card = torch.tensor(noise_np, device=dev)
    for band in K4_ROW_BANDS:
        cfg_b = copy.deepcopy(cfg)
        cfg_b.detector.band_size = band
        static, params = build_bundle([("w", ww)], cfg_b, dev)
        assert static.dtw_k4_for_band and static.dtw_fused_variant == 2
        step, eager = GraphedStep(make_step(static)), make_step(static)
        process = lambda s, f: step(params, s, f)
        s0 = torch.tensor(correctness_stream(static.max_mfcc_frames, utterance), device=dev)
        reset_counts()
        evs = run_pass(process, init_state(static, B, dev), s0, noise_card)
        torch.cuda.synchronize()
        launches = read_counts()
        n = s0.shape[0]
        assert_launches(launches, {"fused_dtw_v2": 3 * n, **step_front(n)},
                        f"F1 w={band} make_step at B={B}")
        device = []
        _, windows = timed_windows(process, init_state(static, B, dev), noise_card, device)
        host_ms = float(np.median(windows)) / TIMED_CHUNKS * 1e3
        graph_ms = float(np.median(device)) / TIMED_CHUNKS * 1e3
        states = init_state(static, B, dev)
        rows = device_kernels(lambda: eager(params, states, noise_card), PROFILED_CHUNKS)
        k4_ms = sum(r[0] for r in rows if "score_pairs_v2" in r[2])
        k4_n = sum(r[1] for r in rows if "score_pairs_v2" in r[2])
        if band == record["fused_dtw_v2_column"]["band"]:
            record["fused_dtw_v2_column"]["launches"] = launches["fused_dtw_v2"]
        log(f"F1 w={band} make_step at B={B} [{card}]: K4 ({fd.k4_form(band, 16)} form) launches "
            f"{launches['fused_dtw_v2']} in the {n}-chunk pass, stream 0 fired "
            f"{int(evs[0][:, 0].sum())}x; graphed {host_ms:.4f} ms per chunk host clock (median "
            f"of {TIMED_WINDOWS} windows of {TIMED_CHUNKS}), graph device {graph_ms:.4f} ms; "
            f"profiled eager: K4 {k4_ms:.4f} ms per chunk in {k4_n:.1f} launches "
            f"({k4_ms / max(k4_n, 1):.4f} ms per launch) of {sum(r[0] for r in rows):.4f} ms")
        summary[f"k4_column_w{band}"] = dict(launches=launches["fused_dtw_v2"], chunks=n,
                                             host_ms=host_ms, graph_device_ms=graph_ms,
                                             k4_ms_per_chunk=k4_ms, k4_launches_per_chunk=k4_n)

    # (e) M6b: the NN wakeword joins a live B=8192 DTW fleet mid-stream;
    # the same calls on the CPU at B=4
    # The eager run goes first, so that the allocator holds the eager chunk's
    # blocks of both bundles when the graphed run captures: the reserved
    # memory a capture adds is then its graph's pool.
    split = 10
    outs, calls = {}, []
    for run_as, d, b in (("eager", dev, B), ("graph", dev, B), ("cpu", "cpu", 4)):
        det = BatchedDetector([("w", ww)], cfg, batch_size=b, device=d)
        noise = torch.tensor(noise_np[:b], device=d)
        s0 = torch.tensor(stream0_np, device=d)
        if run_as == "eager":  # the eager chunk of each bundle, rebuilt after the add
            chunks = {}
            run = lambda s, f: chunks.setdefault(id(det.static), make_batched_chunk(det.static))(
                det.params, s, f)
        elif run_as == "graph":  # each call timed, with the memory reserved around it
            def run(s, f):
                torch.cuda.synchronize()
                reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
                out = det.process_chunk(det.params, s, f)
                torch.cuda.synchronize()
                calls.append((time.perf_counter() - t0, reserved, torch.cuda.memory_reserved()))
                return out
        else:
            run = lambda s, f: det.process_chunk(det.params, s, f)
        reset_counts()
        states = det.init_states()
        before = run_pass(run, states, s0[:split], noise)
        states = det.add_wakeword("n", firing, states)
        assert det.wakeword_names == ("w", "n") and states.win.shape[0] == firing.train_size
        outs[run_as] = (before, run_pass(run, states, s0[split:], noise), states)
        if run_as == "graph":
            torch.cuda.synchronize()
            launches = read_counts()
            graphed_det, graphed_noise = det, noise
    assert launches["fused_dtw_v4"] == len(stream0_np), launches
    (gb, ga, gs), (eb, ea, es) = outs["graph"], outs["eager"]
    same = (match_graph(gb, eb, None, None, "M6b before the add, graph vs eager", EV_RTOL,
                        EV_ATOL)
            & match_graph(ga, ea, gs, es, "M6b after the add, graph vs eager", NN_RTOL,
                          NN_ATOL))
    log(f"M6b: the graphed chunks before and after the add give the eager chunks' events on "
        f"all {B} streams and the same final states (bit-equal {same})")
    replays_run("M6b after the add", lambda: graphed_det.process_chunk(
        graphed_det.params, gs, graphed_noise), partial(make_batched_chunk(graphed_det.static),
                                                        graphed_det.params, es, graphed_noise),
        launches, len(stream0_np))
    # what a capture costs: the first chunk of a bundle runs eagerly, then captures
    (first_s, first_r0, first_r1), (add_s, add_r0, add_r1) = calls[0], calls[split]
    replay_ms = float(np.median([c[0] for i, c in enumerate(calls) if i not in (0, split)])) * 1e3
    mib = lambda r: r / 2 ** 20
    log(f"M6b [{card}]: host ms of a bundle's first chunk (the eager chunk, then the capture) "
        f"{first_s * 1e3:.4f} at the start and {add_s * 1e3:.4f} after add_wakeword, against "
        f"{replay_ms:.4f} per replayed chunk (median of {len(calls) - 2}); memory reserved "
        f"{mib(first_r0):.1f} -> {mib(first_r1):.1f} MiB over the first capture, "
        f"{mib(add_r0):.1f} -> {mib(add_r1):.1f} MiB over the capture after the add")
    summary.update(m6b_first_chunk_ms=first_s * 1e3, m6b_add_first_chunk_ms=add_s * 1e3,
                   m6b_replay_ms=replay_ms, m6b_capture_reserved_mib=mib(first_r1 - first_r0),
                   m6b_add_capture_reserved_mib=mib(add_r1 - add_r0))
    host = {k: [[f[:, :4].cpu().numpy() for f in part] for part in v[:2]]
            for k, v in outs.items()}
    match_events(host["graph"][0], host["cpu"][0], "M6b before the add")
    n_events, worst = match_events(host["graph"][1], host["cpu"][1], "M6b after the add",
                                   NN_RTOL, NN_ATOL)
    fired0 = int(host["graph"][1][0][:, 0].sum())
    assert fired0 >= 1, "M6b: stream 0 did not fire after the NN wakeword joined"
    log(f"M6b: NN wakeword added to the live B={B} DTW fleet after {split} chunks; the "
        f"{len(stream0_np) - split} chunks after it match the cpu run at B=4 ({n_events} "
        f"events, stream 0 fired {fired0}x, max|d score| {worst:.3e}); K1 launches "
        f"{launches['fused_dtw_v4']}")
    summary.update(management_memory(dev, card, ww, firing, cfg, noise_card))
    summary.update(reset_turns(dev, card, ww, cfg, noise_card))
    return summary


MANAGEMENT_CALLS = 10
RESET_CALLS = 50  # reset_streams calls per timed turn
MIB = 2 ** 20


def management_memory(dev, card, ww, firing, cfg, noise):
    """The memory of management calls at B=8192 (F4's question): the NN
    wakeword added, then removed, in turns, each call followed by a graphed
    chunk, which captures. Ten calls read before and after `empty_cache`
    (allocated and reserved); ten more never emptied, then one tensor as
    large as the reserved memory they left is allocated. Raises unless the
    allocated memory, and the reserved memory after `empty_cache`, are the
    same after every call of the same bundle."""
    import gc

    import torch

    from rustpotter_tpu_torch.runtime.batch import BatchedDetector

    det = BatchedDetector([("w", ww)], cfg, batch_size=BENCH_STREAMS, device=dev)
    states = det.init_states()
    states, _ = det.process_chunk(det.params, states, noise)

    def call(i, states):
        if i % 2 == 0:
            states = det.add_wakeword("n", firing, states)
        else:
            states = det.remove_wakeword("n", states)
        states, _ = det.process_chunk(det.params, states, noise)
        gc.collect()
        torch.cuda.synchronize()
        return states

    mem = lambda: (torch.cuda.memory_allocated() / MIB, torch.cuda.memory_reserved() / MIB)
    torch.cuda.empty_cache()
    start = mem()
    rows = []
    for i in range(MANAGEMENT_CALLS):
        states = call(i, states)
        before = mem()
        torch.cuda.empty_cache()
        rows.append((*before, *mem()))
    log(f"F4 [{card}]: memory after each of {MANAGEMENT_CALLS} management calls at "
        f"B={BENCH_STREAMS} (add, remove, ...; each then a graphed chunk, which captures), "
        f"MiB allocated / reserved before empty_cache -> allocated / reserved after, from "
        f"{start[0]:.1f} / {start[1]:.1f}: "
        + "; ".join(f"{a0:.1f} / {r0:.1f} -> {a1:.1f} / {r1:.1f}" for a0, r0, a1, r1 in rows))
    base = mem()
    for i in range(MANAGEMENT_CALLS):
        states = call(i, states)
    grown = mem()
    growth = int((grown[1] - base[1]) * MIB)
    try:
        big = torch.empty(max(growth, 1), dtype=torch.uint8, device=dev)
        big.fill_(1)
        torch.cuda.synchronize()
        after, held = mem(), "succeeded"
        del big
    except torch.cuda.OutOfMemoryError:
        after, held = mem(), "failed (out of memory)"
    log(f"F4 [{card}]: {MANAGEMENT_CALLS} more calls without empty_cache: reserved "
        f"{base[1]:.1f} -> {grown[1]:.1f} MiB (+{grown[1] - base[1]:.1f}), allocated "
        f"{base[0]:.1f} -> {grown[0]:.1f}; one tensor of {growth / MIB:.1f} MiB then {held}, "
        f"reserved {grown[1]:.1f} -> {after[1]:.1f} MiB (+{after[1] - grown[1]:.1f})")
    for i in range(2, MANAGEMENT_CALLS):  # the same bundle as two calls before
        assert rows[i][2] == rows[i - 2][2], ("F4: memory allocated grows", rows)
        assert rows[i][3] <= rows[i % 2][3], ("F4: reserved after empty_cache grows", rows)
    return {"f4_rows_mib": rows, "f4_start_mib": start,
            "f4_no_empty_cache_mib": (base, grown, after), "f4_big_alloc": held}


def reset_turns(dev, card, ww, cfg, noise):
    """`reset_streams` at B=8192 after 20 graphed chunks, graphed (the
    detector's) against eager (`make_reset` called directly) on copies of
    the same states: every field bit for bit with a mixed, an all-true and
    an all-false mask; host ms per call (a numpy mask each, RESET_CALLS
    calls synchronized at the end) in turns eager, graph, graph, eager;
    then a chunk, which must replay without a capture and give the eager
    chunk's events."""
    import torch

    from rustpotter_tpu_torch.runtime.batch import BatchedDetector, make_reset
    from rustpotter_tpu_torch.runtime.state import StreamState
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk

    B = BENCH_STREAMS
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev)
    eager = make_reset(det.static, dev)
    states = det.init_states()
    for _ in range(20):
        states, _ = det.process_chunk(det.params, states, noise)
    base = [t.clone() for t in states]
    mine = StreamState(*[t.clone() for t in base])
    masks = {"mixed": np.arange(B) % 3 == 0, "all": np.ones(B, bool), "none": np.zeros(B, bool)}
    graphed = lambda s, m: det.reset_streams(s, m)
    direct = lambda s, m: eager(det.params, s, torch.as_tensor(m, device=dev))
    captures = det._chunk.captures
    for name, m in masks.items():
        for _ in range(2):  # the capture, then a replay
            for a, b, c in zip(states, mine, base):
                a.copy_(c)
                b.copy_(c)
            graphed(states, m)
            direct(mine, m)
            assert all(bits_equal(a, b) for a, b in zip(states, mine)), f"reset {name}"
    assert det._reset.captures == 1, det._reset.captures
    ms = {"eager": [], "graph": []}
    for which in ("eager", "graph", "graph", "eager"):
        fn, s = (direct, mine) if which == "eager" else (graphed, states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RESET_CALLS):
            fn(s, masks["mixed"] if i % 2 else masks["none"])
        torch.cuda.synchronize()
        ms[which].append((time.perf_counter() - t0) * 1e3 / RESET_CALLS)
    for a, b, c in zip(states, mine, base):
        a.copy_(c)
        b.copy_(c)
    graphed(states, masks["mixed"])
    direct(mine, masks["mixed"])
    _, ev = det.process_chunk(det.params, states, noise)
    _, ev_e = make_batched_chunk(det.static)(det.params, mine, noise)
    for j, name in ((0, "fired"), (1, "ww"), (4, "counter")):
        assert torch.equal(ev[j], ev_e[j]), f"the chunk after a reset: {name}"
    same = all(bits_equal(a, b) for a, b in zip(ev, ev_e))
    assert det._chunk.captures == captures, "the chunk after a reset captured again"
    log(f"M6c reset_streams at B={B} [{card}]: graphed equals eager bit for bit on every "
        f"field (mixed, all-true, all-false masks; 1 capture); host ms per call (a numpy "
        f"mask, {RESET_CALLS} calls) in turns eager {ms['eager'][0]:.4f} / graph "
        f"{ms['graph'][0]:.4f} / graph {ms['graph'][1]:.4f} / eager {ms['eager'][1]:.4f}; "
        f"the next chunk replayed without a capture, events as the eager chunk's "
        f"(bit-equal {same})")
    return {"reset_eager_ms": ms["eager"], "reset_graph_ms": ms["graph"]}


# ------------------------------------------------------- audio front-end

BIQUAD_REPLACES = ("rustpotter_tpu/runtime/stream_step.py:470-506 (prepare_chunk's gain "
                   "normalizer and band-pass lax.scan, not Pallas kernels)")
BQ_W = 33  # the gain window of the bench wakeword (100 frames // 3)
GAIN_09 = np.float32(9) * np.float32(0.1)  # the steps' gain at k = 9, 0x3F666667


def front_inputs(rng, B, n, W, chunk):
    """One chunk of the front-end kernel's inputs (numpy), as
    tests/test_torch_front_cuda.py makes them: per stream a level L
    log-uniform in [0.04, 8] gives window entries and an rms within x0.5-1.5
    of it (ref 0.25: gains over every step 0.1 .. 1.0), counts 0 .. W,
    every 16th stream exact silence, N(0, 0.3) samples with an impulse of
    3.0, and stream 3 a NaN sample (and rms) in chunk 1."""
    level = np.exp(rng.uniform(np.log(0.04), np.log(8.0), B))
    rms = (level * rng.uniform(0.5, 1.5, B)).astype(np.float32)
    win = (level[:, None] * rng.uniform(0.5, 1.5, (B, W))).astype(np.float32)
    count = rng.integers(0, W + 1, B).astype(np.int32)
    x = rng.normal(0, 0.3, (B, n)).astype(np.float32)
    x[np.arange(B), rng.integers(0, n, B)] = 3.0
    silent = np.arange(B) % 16 == 5
    rms[silent], x[silent] = 0.0, 0.0
    if chunk == 1:
        x[3, 10] = rms[3] = np.nan
    return rms, win, count, x


def bits_or_nan_equal(got, want) -> bool:
    """Equal bits where `want` is a number, NaN where it is NaN."""
    import torch

    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want) if want.is_floating_point() else torch.zeros_like(want, dtype=bool)
    if not torch.equal(torch.isnan(got) if got.is_floating_point() else nan, nan):
        return False
    if not want.is_floating_point():
        return torch.equal(got, want)
    return torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


def biquad_phase(dev, record):
    """The front-end kernel (csrc/biquad.cu: the gain normalizer, then the
    band-pass) against its plain version run on a CPU copy of the inputs,
    bit for bit, in each form (gain and band-pass, band-pass only, gain
    only) over 3 chunks with the window, count and taps carried in place as
    the stream steps carry them (the ref NaN in chunk 2): at the bench shape
    (B = 8192, 480 samples, the bulk form) and at B = 1000, 477 samples (the
    simple form). Then its time at the bench shape in each form beside the
    plain version's and the bounds."""
    import torch

    from rustpotter_tpu_torch.audio.filters import band_pass_coefficients
    from rustpotter_tpu_torch.ops import biquad

    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0)
    forms = {"both": (True, True), "band_pass": (False, True), "gain": (True, False)}
    rng = np.random.default_rng(12)
    worst, steps = 0.0, set()
    for B, n in ((BENCH_STREAMS, 480), (1000, 477)):
        for form, (gain_on, bp_on) in forms.items():
            _, win, count, _ = front_inputs(rng, B, n, BQ_W, 0)
            card = [torch.tensor(win, device=dev), torch.tensor(count, device=dev),
                    torch.zeros(B, device=dev), torch.zeros(B, 4, device=dev)]
            cpu = [t.cpu().clone() for t in card]
            for c in range(3):
                rms, _, _, x = front_inputs(rng, B, n, BQ_W, c)
                ref = np.float32(np.nan if c == 2 else 0.25)
                outs = []
                for d, (w, k, g, taps) in ((dev, card), ("cpu", cpu)):
                    gain = (biquad.GainIn(torch.tensor(rms, device=d), torch.tensor(ref, device=d),
                                          0.1, 1.0, w, k) if gain_on else None)
                    into = (dict(win_out=w, count_out=k, gain_out=g, taps_out=taps)
                            if d == dev else {})
                    outs.append(biquad.front(torch.tensor(x, device=d), gain,
                                             coeffs if bp_on else None, taps if bp_on else None,
                                             **into))
                torch.cuda.synchronize()
                f_k, f_p = outs
                for name in ("out", "win", "count", "gain", "taps"):
                    k_t, p_t = getattr(f_k, name), getattr(f_p, name)
                    if p_t is None:
                        continue
                    if not bits_or_nan_equal(k_t, p_t):
                        raise AssertionError(f"biquad {form} B={B} n={n} chunk {c}: {name} "
                                             f"differs from the plain version")
                    if p_t.is_floating_point():
                        fin = torch.isfinite(p_t)
                        worst = max(worst, float((k_t.cpu()[fin] - p_t[fin]).abs().max()))
                if gain_on:
                    cpu[:3] = [f_p.win, f_p.count, f_p.gain]
                    steps.update(f_p.gain.numpy().tolist())
                if bp_on:
                    cpu[3] = f_p.taps
    want = {float(np.float32(k) * np.float32(biquad.GAIN_STEP)) for k in range(1, 11)}
    assert want <= steps and float(GAIN_09) in steps, sorted(want - steps)
    log(f"biquad: the kernel is bit-equal to its plain version on a cpu copy in its 3 forms at "
        f"B={BENCH_STREAMS} x 480 (bulk form) and B=1000 x 477 (simple form), 3 chunks with "
        f"the state carried in place, W={BQ_W}; gains over every step 0.1-1.0, NaN, silence")

    B, n, W = BENCH_STREAMS, 480, BQ_W
    rms, win, count, x = (torch.tensor(a, device=dev) for a in front_inputs(rng, B, n, W, 0))
    ref = torch.tensor(np.float32(0.25), device=dev)
    st = [win, count, torch.zeros(B, device=dev), torch.zeros(B, 4, device=dev)]
    into = dict(zip(("win_out", "count_out", "gain_out", "taps_out"), st))
    gain = biquad.GainIn(rms, ref, 0.1, 1.0, win, count)

    def run(form):
        g, bp = forms[form]
        return lambda: biquad.front(x, gain if g else None, coeffs if bp else None,
                                    st[3] if bp else None, **into)

    # the kernel's device time: launches back to back replayed from a CUDA
    # graph, since the wrapper's Python is longer than the kernel; CUDA
    # events around wrapper calls beside it (the band-pass kernel's first
    # design was timed that way), and the host time of a wrapper call
    ms = {form: time_cuda_graph(run(form)) for form in forms}
    events_ms = {form: time_cuda(run(form)) for form in forms}
    host_us = {form: 1e3 * host_ms_per_call(run(form)) for form in forms}
    plain_ms = time_cuda(lambda: biquad.front_plain(x, gain, coeffs, st[3]), samples=3, per=1,
                         warmup=1)
    # bytes: the samples read and written, the window read and written, the
    # taps read and written, rms, count in and out, gain out; operations: per
    # sample the gain's product, 5 products and 4 sums; per stream the
    # window's W - 1 sums, the mean, root, quotient and rounding (~W + 5)
    work = {"both": (10 * B * n + (W + 5) * B, 4 * (2 * B * n + 2 * B * W + 2 * B * 4 + 4 * B)),
            "band_pass": (9 * B * n, 4 * (2 * B * n + 2 * B * 4)),
            "gain": (B * n + (W + 5) * B, 4 * (2 * B * n + 2 * B * W + 4 * B))}
    for form in forms:
        b_ms, b_by = bound(*work[form])
        log(f"biquad {form} at {B} x {n}: {ms[form]:.4f} ms on the device (CUDA graph), "
            f"{events_ms[form]:.4f} ms a wrapper call (CUDA events), {host_us[form]:.2f} us "
            f"of host time a wrapper call; bound {b_ms:.4f} ms by {b_by} "
            f"({100 * b_ms / ms[form]:.1f} % of it)")
    record["biquad"] = kernel_row("biquad", "biquad.cu", BIQUAD_REPLACES, worst, ms["both"],
                                  plain_ms, *work["both"])
    return {**{f"biquad_{form}_ms": v for form, v in ms.items()},
            **{f"biquad_{form}_events_ms": v for form, v in events_ms.items()},
            **{f"biquad_{form}_host_us": v for form, v in host_us.items()}}


MFCC_FRONT_REPLACES = {
    "mfcc_prologue": "rustpotter_tpu/ops/frontend.py pre_emphasis and "
                     "rustpotter_tpu/runtime/stream_step.py make_batched_chunk's extractor "
                     "buffer (XLA fusions)",
    "mfcc_epilogue": "rustpotter_tpu/ops/frontend.py mfcc_from_frames after the DFT product "
                     "(XLA fusions and the mel and DCT products)",
}
MFCC_BANDS = 17  # the bench wakeword's 16 coefficients + 1
MFCC_STREAMS = (BENCH_STREAMS, 65536)  # the served and the backlog cells' B


def mfcc_front_phase(dev, record):
    """The MFCC front-end's kernels (csrc/mfcc_front.cu) against their plain
    versions on the same card tensors at the batched chunk's shapes (B =
    8192 and 65536, 17 bands), stream 0 silent: the prologue's frames and
    buffer bit-equal, its rms within rtol 2e-6; the epilogue within rtol
    1e-5 / atol 1e-5 in both output layouts, stream 0's rows the exact DCT of
    their constant logs rounded once. Then both kernels' device time (a CUDA
    graph), the plain versions' (CUDA events), and their bounds by bytes."""
    import torch

    from rustpotter_tpu_torch.ops import frontend as fe

    n, C = MFCC_BANDS, MFCC_BANDS - 1
    k = fe.device_constants(n, dev)
    L = float(np.log(fe.F32_MIN_POSITIVE))  # a silent row's logs
    rows = fe.dct_matrix(n)[1:].astype(np.float64)
    silent_row = torch.tensor(np.float32([L * math.fsum(r) for r in rows]), device=dev)
    rng = np.random.default_rng(22)
    worst = {"mfcc_prologue": 0.0, "mfcc_epilogue": 0.0}
    ms, plain_ms, work = {}, {}, {}
    for B in MFCC_STREAMS:
        x = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32), device=dev)
        buf0 = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32), device=dev)
        x[0], buf0[0] = 0.0, 0.0
        for rms in (True, False):
            buf_k, buf_p = buf0.clone(), buf0.clone()
            frames_k, level_k = fe.prologue(x, buf_k, rms)
            frames_p, level_p = fe.prologue_plain(x, buf_p, rms)
            torch.cuda.synchronize()
            assert torch.equal(frames_k, frames_p), f"mfcc_prologue B={B}: frames differ"
            assert torch.equal(buf_k, buf_p), f"mfcc_prologue B={B}: buffer differs"
            if rms:
                torch.testing.assert_close(level_k, level_p, rtol=2e-6, atol=0)
                worst["mfcc_prologue"] = max(worst["mfcc_prologue"],
                                             float((level_k - level_p).abs().max()))
        spec = torch.matmul(frames_k, k.dft)
        assert not spec[0].any(), "the silent stream's spectrum"
        for window in (False, True):
            got, want = fe.epilogue(spec, n, window), fe.epilogue_plain(spec, n, window)
            torch.cuda.synchronize()
            silent = (slice(None), slice(None), 0) if window else 0
            loud = (slice(None), slice(None), slice(1, None)) if window else slice(1, None)
            assert torch.equal(got[silent].reshape(3, C), silent_row.expand(3, C)), (
                f"mfcc_epilogue B={B} window={window}: a silent row is not the exact DCT")
            torch.testing.assert_close(got[loud], want[loud], rtol=1e-5, atol=1e-5)
            worst["mfcc_epilogue"] = max(worst["mfcc_epilogue"],
                                         float((got[loud] - want[loud]).abs().max()))
        buf = buf0.clone()
        ms[B] = {"mfcc_prologue": time_cuda_graph(lambda: fe.prologue(x, buf, True)),
                 "mfcc_epilogue": time_cuda_graph(lambda: fe.epilogue(spec, n, True))}
        plain_ms[B] = {
            "mfcc_prologue": time_cuda(lambda: fe.prologue_plain(x, buf, True), samples=5),
            "mfcc_epilogue": time_cuda(lambda: fe.epilogue_plain(spec, n, True), samples=5)}
        # bytes: the chunk and the buffer read, the frames, the buffer and
        # the rms written; the spectrum read and the MFCCs written. Operations:
        # 2 a sample each for the pre-emphasis and the rms; a row's power (3 a
        # bin), the walk's two FMAs a bin (4), the logs and the DCT's FMAs
        work[B] = {"mfcc_prologue": (4 * 480 * B, 4 * (2 * 480 + 4 * 480 + 1) * B),
                   "mfcc_epilogue": ((7 * 240 + n + 2 * n * C) * 3 * B,
                                     4 * (480 + C) * 3 * B)}
        for name in worst:
            b_ms, b_by = bound(*work[B][name])
            log(f"{name} at B={B}: {ms[B][name]:.4f} ms on the device (CUDA graph), plain "
                f"{plain_ms[B][name]:.4f} ms (CUDA events); bound {b_ms:.4f} ms by {b_by} "
                f"({100 * b_ms / ms[B][name]:.1f} % of it)")
    log(f"mfcc_front: the prologue bit-equal to its plain version (frames, buffer; rms within "
        f"rtol 2e-6, max |d| {worst['mfcc_prologue']:.3e}), the epilogue within rtol 1e-5 / "
        f"atol 1e-5 in both layouts (max |d| {worst['mfcc_epilogue']:.3e}), a silent stream's "
        f"rows exact, at B = {', '.join(map(str, MFCC_STREAMS))}")
    big = MFCC_STREAMS[-1]
    for name in worst:
        record[name] = kernel_row(name, "mfcc_front.cu", MFCC_FRONT_REPLACES[name], worst[name],
                                  ms[big][name], plain_ms[big][name], *work[big][name])
        record[name]["B"] = big
        record[name]["ms_by_B"] = {B: ms[B][name] for B in MFCC_STREAMS}
    return {f"{name}_ms_B{B}": ms[B][name] for B in MFCC_STREAMS for name in worst}


def is_front_kernel(name: str) -> bool:
    """A profile row of csrc/biquad.cu's kernel (either form)."""
    return "front_bulk<" in name or "front_simple<" in name


def _front_split(rows, front_rows, resample_rows, t):
    """The device kernel time per chunk split into the MFCC front-end, the
    resample GEMM, the biquad, K1 and the rest, from torch.profiler rows of
    the chunk, of its front-end alone and of the resampler alone."""
    biquad_ms = sum(r[0] for r in rows if is_front_kernel(r[2]))
    k1_ms = sum(r[0] for r in rows if "score_pairs" in r[2])
    resample_ms = sum(r[0] for r in resample_rows)
    front_ms = sum(r[0] for r in front_rows)
    return {"front_ms": front_ms - resample_ms - biquad_ms, "resample_ms": resample_ms,
            "biquad_ms": biquad_ms, "k1_ms": k1_ms, "rest_ms": t["kernel_ms"] - front_ms - k1_ms}


def _log_cell(name, card, t, parts, rows):
    """The host clock line and, where the profiler saw the device, the
    split of the device time per chunk into `parts` {label: ms}."""
    log(f"{name} [{card}]: {t['streams_rt']:.1f} realtime streams graphed, median of "
        f"{2 * TIMED_WINDOWS} windows (range {t['streams_rt_min']:.1f}-{t['streams_rt_max']:.1f}; "
        f"B={BENCH_STREAMS}, {TIMED_CHUNKS} chunks per window, {t['chunk_ms']:.4f} ms/chunk host "
        f"clock; eager {t['eager_chunk_ms']:.4f})")
    if not rows:
        log(f"{name}: the profiler recorded no device time: the breakdown is not measured")
        return
    split = ", ".join(f"{label} {ms:.4f} ms" for label, ms in parts.items())
    log(f"{name} [{card}]: device kernels per eager chunk {t['kernel_ms']:.4f} ms in "
        f"{sum(r[1] for r in rows):.1f} launches of {len(rows)} kernels: {split}; device idle "
        f"{100 * (1 - t['kernel_ms'] / t['eager_chunk_ms']):.1f} % of the eager host clock, "
        f"{100 * (1 - t['kernel_ms'] / t['chunk_ms']):.1f} % of the graph's")
    for ms, count, kname in rows[:PROFILE_ROWS]:
        log(f"profile {name}: {ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  {kname[:110]}")


def _resample_rows(name, card, det, noise):
    """Profile rows of the chunk's resampler alone (none at 16 kHz), and its
    time by CUDA events beside the GEMM's bound and FLOP rate."""
    import torch

    from rustpotter_tpu_torch.audio.resampler import make_torch_resampler

    B, n_in = noise.shape
    if n_in == 480:
        return [], {}
    resample = make_torch_resampler(n_in, 480, noise.device)
    overlap = torch.zeros(B, 480, device=noise.device)
    rows = device_kernels(lambda: resample(overlap, noise), PROFILED_CHUNKS)
    ms = time_cuda(lambda: resample(overlap, noise))
    flops = 2 * B * n_in * 960
    bound_ms, bound_by = bound(flops, 4 * (B * n_in + n_in * 960 + 2 * B * 480))
    log(f"{name} resampler [{card}]: {ms:.4f} ms per chunk by CUDA events (the fp32 GEMM "
        f"{B} x {n_in} x 960, {flops / 1e9:.2f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s, and the "
        f"overlap add); bound {bound_ms:.4f} ms by {bound_by}")
    for r_ms, count, kname in rows:
        log(f"profile {name} resampler: {r_ms:9.4f} ms/chunk  {count:5.1f} launches/chunk  "
            f"{kname[:110]}")
    return rows, {"resample_event_ms": ms, "resample_bound_ms": bound_ms}


def match_gains(gpu_states, cpu_states, name, gain_on):
    """Raises unless the gains of streams 0-3 after a pass equal the CPU
    run's bit for bit, and (with the gain normalizer on) stream 1, at noise
    0.062, holds the steps' 0.9 (0x3F666667)."""
    g, c = gpu_states.gain[:4].cpu().numpy(), cpu_states.gain[:4].numpy()
    assert (g.view(np.uint32) == c.view(np.uint32)).all(), (name, g, c)
    if gain_on:
        assert g[1].view(np.uint32) == GAIN_09.view(np.uint32) == 0x3F666667, (name, g)
    return [float(v) for v in g]


RMS_LAUNCHES = 3  # frontend.rms_level: square, mean, sqrt


def filtered_launches(name, fn, ref_fn, readings=5, rms_fused=False):
    """Raises unless the launches per chunk of fn (a chunk with the filters
    on) pass those of ref_fn (the same path with the filters off) by the one
    front-end launch at most, and by the rms's launches too where the path
    takes the rms in its MFCC prologue without filters (`rms_fused`: the
    batched chunk; with them, the rms is of the samples before the filters):
    no torch kernel of the filters is left. Each side is the median of
    `readings` torch.profiler readings taken in turns:
    a profile may drop records, or take in some that the one before it left
    (readings of 458.6 for 469 launches and of 437.0 for 434 were seen on an
    H100). Returns both."""
    def launches(f):  # launches in PROFILED_CHUNKS chunks, an integer
        return round(PROFILED_CHUNKS * sum(r[1] for r in device_kernels(f, PROFILED_CHUNKS)))

    got, ref = [], []
    for _ in range(readings):
        got.append(launches(fn))
        ref.append(launches(ref_fn))
    got, ref = int(np.median(got)), int(np.median(ref))
    log(f"{name}: {got / PROFILED_CHUNKS:.1f} launches per chunk, {ref / PROFILED_CHUNKS:.1f} "
        f"with the filters off (the median of {readings} profiles each)")
    assert got <= ref + (1 + RMS_LAUNCHES * rms_fused) * PROFILED_CHUNKS, (name, got, ref)
    return got / PROFILED_CHUNKS, ref / PROFILED_CHUNKS


def front_batched(dev, card, name, ww, cfg, stream0_np, noise_np, in_graph_resample=False,
                  ref_cfg=None):
    """One front-end cell through BatchedDetector at B=8192 (K1): the
    correctness pass (stream 0 must fire, K1 once per chunk, the front-end
    kernel once per chunk with a filter on and never without, no other
    kernel), streams 0-3 against a device="cpu" run at B=4 (events, and the
    gains after the pass bit for bit), then the host clock and the device
    split; with `ref_cfg` (the same configuration, filters off) the launches
    per chunk are held to that detector's (`filtered_launches`). Returns
    the summary and the front-end kernel's launches."""
    import torch

    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk

    B = BENCH_STREAMS
    noise = torch.tensor(noise_np, device=dev)
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev,
                          in_graph_resample=in_graph_resample)
    n = stream0_np.shape[0]
    fronts = n if det.static.bp_enabled or det.static.gain_enabled else 0
    states = det.init_states()
    eager = make_batched_chunk(det.static)
    gpu, launches, same = graph_pass(
        f"{name} BatchedDetector", lambda s, f: det.process_chunk(det.params, s, f),
        lambda s, f: eager(det.params, s, f), states, det.init_states(),
        torch.tensor(stream0_np, device=dev), noise)
    fired0 = int(gpu[0][:, 0].sum())
    log(f"{name} BatchedDetector: correctness pass {n} chunks of {det.static.input_samples} "
        f"samples at B={B}, stream 0 fired {fired0}x, launches {launches}")
    assert fired0 >= 1, f"correctness guard: {name} did not fire on stream 0"
    assert_launches(launches, {"fused_dtw_v4": n, "biquad": fronts, **batched_front(n)}, name)
    cpu_det = BatchedDetector([("w", ww)], cfg, batch_size=4, device="cpu",
                              in_graph_resample=in_graph_resample)
    cpu_states = cpu_det.init_states()
    cpu = run_correctness(lambda s, f: cpu_det.process_chunk(cpu_det.params, s, f),
                          cpu_states, torch.tensor(stream0_np), torch.tensor(noise_np[:4]))
    n_events, worst = match_events(gpu, cpu, f"{name} BatchedDetector")
    np.testing.assert_array_equal(gpu[5], cpu[5], err_msg=f"{name}: event gain, card vs cpu")
    gains = match_gains(states, cpu_states, f"{name} BatchedDetector", det.static.gain_enabled)
    log(f"{name} BatchedDetector: streams 0-3 match the cpu run at B=4 ({n_events} events, "
        f"max|d score| {worst:.3e}, event gains equal, gains after the pass {gains} bit-equal)")
    t, rows, front_rows = chunk_timing(det, noise, f"{name} BatchedDetector", card)
    t["graph_bit_equal"] = same
    resample_rows, resample_t = _resample_rows(name, card, det, noise)
    split = {**_front_split(rows, front_rows, resample_rows, t), **resample_t}
    _log_cell(f"{name} BatchedDetector", card, t, {
        "front-end": split["front_ms"], "resample GEMM": split["resample_ms"],
        "biquad": split["biquad_ms"], "K1": split["k1_ms"], "rest": split["rest_ms"]}, rows)
    split["launches_per_chunk"] = sum(r[1] for r in rows)
    if rows and ref_cfg is not None:
        ref = BatchedDetector([("w", ww)], ref_cfg, batch_size=B, device=dev,
                              in_graph_resample=in_graph_resample)
        ref_states, ref_eager = ref.init_states(), make_batched_chunk(ref.static)
        filtered_launches(f"{name} BatchedDetector",
                          lambda: eager(det.params, states, noise),
                          lambda: ref_eager(ref.params, ref_states, noise), rms_fused=True)
    return {f"{name}_{k}": v for k, v in {**t, **split}.items()}, launches["biquad"]


def front_step(dev, card, name, ww, cfg, stream0_np, noise_np, ref_cfg=None):
    """The same cell through make_step at B=8192 in its default mode (K2):
    3 K2 launches and one front-end launch per chunk, streams 0-3 against a
    device="cpu" run (events, and the gains after the pass bit for bit),
    the host clock and the device split; with `ref_cfg` the launches per
    chunk held to those of make_step built from it (`filtered_launches`)."""
    import torch

    from rustpotter_tpu_torch.runtime.bundle import build_bundle
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.state import init_state
    from rustpotter_tpu_torch.runtime.stream_step import make_step

    B = BENCH_STREAMS
    noise = torch.tensor(noise_np, device=dev)
    static, params = build_bundle([("w", ww)], cfg, dev)
    _, params_cpu = build_bundle([("w", ww)], cfg, "cpu")
    step, graphed = make_step(static), GraphedStep(make_step(static))
    n = stream0_np.shape[0]
    states = init_state(static, B, dev)
    gpu, launches, same = graph_pass(
        f"{name} make_step", lambda s, f: graphed(params, s, f), lambda s, f: step(params, s, f),
        states, init_state(static, B, dev), torch.tensor(stream0_np, device=dev), noise)
    assert int(gpu[0][:, 0].sum()) >= 1, f"correctness guard: {name} make_step did not fire"
    assert_launches(launches, {"fused_dtw_v3": 3 * n, "biquad": n, **step_front(n)},
                    f"{name} make_step")
    cpu_step = make_step(static)
    cpu_states = init_state(static, 4, "cpu")
    cpu = run_correctness(lambda s, f: cpu_step(params_cpu, s, f), cpu_states,
                          torch.tensor(stream0_np), torch.tensor(noise_np[:4]))
    n_events, worst = match_events(gpu, cpu, f"{name} make_step")
    np.testing.assert_array_equal(gpu[5], cpu[5], err_msg=f"{name} make_step: event gain")
    gains = match_gains(states, cpu_states, f"{name} make_step", static.gain_enabled)
    log(f"{name} make_step: {n} chunks, K2 launches {launches['fused_dtw_v3']}, biquad "
        f"{launches['biquad']}; streams 0-3 match the cpu run at B=4 ({n_events} events, "
        f"max|d score| {worst:.3e}, gains after the pass {gains} bit-equal)")
    turns, windows, graph_device_ms = eager_graph_turns(
        f"{name} make_step", card, lambda s, f: step(params, s, f),
        lambda s, f: graphed(params, s, f), lambda: init_state(static, B, dev), noise)
    states = init_state(static, B, dev)
    audio_s = B * TIMED_CHUNKS * 0.03
    gw = windows["graph"]
    t = {"streams_rt": audio_s / float(np.median(gw)),
         "streams_rt_min": audio_s / max(gw), "streams_rt_max": audio_s / min(gw),
         "chunk_ms": float(np.median(gw)) / TIMED_CHUNKS * 1e3,
         "eager_chunk_ms": float(np.median(windows["eager"])) / TIMED_CHUNKS * 1e3,
         "eager_ms_turns": turns["eager"], "graph_ms_turns": turns["graph"],
         "graph_device_ms": graph_device_ms, "graph_bit_equal": same}
    rows = device_kernels(lambda: step(params, states, noise), PROFILED_CHUNKS)
    t["kernel_ms"] = sum(r[0] for r in rows)
    gemm_ms = sum(r[0] for r in rows if "gemm" in r[2].lower())
    biquad_ms = sum(r[0] for r in rows if is_front_kernel(r[2]))
    k2_ms = sum(r[0] for r in rows if "score_pairs" in r[2])
    _log_cell(f"{name} make_step", card, t, {
        "GEMMs": gemm_ms, "biquad": biquad_ms, "K2": k2_ms,
        "rest": t["kernel_ms"] - gemm_ms - biquad_ms - k2_ms}, rows)
    if rows and ref_cfg is not None:
        ref_static, ref_params = build_bundle([("w", ww)], ref_cfg, dev)
        ref_step, ref_states = make_step(ref_static), init_state(ref_static, B, dev)
        filtered_launches(f"{name} make_step", lambda: step(params, states, noise),
                          lambda: ref_step(ref_params, ref_states, noise))
    return {f"{name}_step_{k}": v for k, v in {
        **t, "gemm_ms": gemm_ms, "biquad_ms": biquad_ms, "k2_ms": k2_ms,
        "launches_per_chunk": sum(r[1] for r in rows)}.items()}


def front_rustpotter(dev, card, name, ww, cfg, frames_np, bp):
    """The single-stream Rustpotter through process_samples on the card and
    on the CPU: equal detections, 3 K2 launches per frame and `bp` biquad
    launches per frame; ms per process_samples (host encoder included) and
    of the host encoder alone."""
    rps = single_streams(cfg, dev, [("w", ww)])
    n = len(frames_np)
    gpu_dets, secs, launches, _ = rustpotter_graph_vs_eager(f"{name} Rustpotter", rps[0], rps[1],
                                                            frames_np)
    cpu_dets, _ = play_single_stream(rps[2], frames_np)
    assert gpu_dets, f"correctness guard: {name} Rustpotter did not fire"
    assert_launches(launches, {"fused_dtw_v3": 3 * n, "biquad": bp * n, **step_front(n)},
                    f"{name} Rustpotter")
    worst = match_detections(gpu_dets, cpu_dets, f"{name} Rustpotter")
    enc = rps[0].wav_encoder
    enc.reset()
    enc_secs = []
    for frame in frames_np:
        t0 = time.perf_counter()
        enc.rencode_and_resample(frame)
        enc_secs.append(time.perf_counter() - t0)
    rp_ms, enc_ms = float(np.median(secs)) * 1e3, float(np.median(enc_secs)) * 1e3
    log(f"{name} Rustpotter [{card}]: fired at frames {[i for i, _ in gpu_dets]} as the cpu "
        f"run (max|d score| {worst:.3e}, gain {[d.gain for _, d in gpu_dets]}); K2 launches "
        f"{launches['fused_dtw_v3']}, biquad {launches['biquad']} for {n} frames of "
        f"{len(frames_np[0])} samples; {rp_ms:.4f} ms per process_samples, median of {n} "
        f"(range {min(secs) * 1e3:.4f}-{max(secs) * 1e3:.4f}), of which the host encoder "
        f"{enc_ms:.4f} ms (median) host clock")
    return {f"{name}_rp_ms": rp_ms, f"{name}_rp_encoder_ms": enc_ms}


def front_phase(dev, card, record):
    """The audio front-end cells (see the module docstring, phase 7):
    `dtw_filters` (gain normalizer and band-pass on, 16 kHz; stream 1 at
    noise 0.062, gain 0.9) through BatchedDetector, make_step and
    Rustpotter, and `dtw_48k` (48 kHz F32, in-graph resampling) through
    BatchedDetector, with Rustpotter at 48 kHz int16 through the host
    encoder. The filtered cells' launches per chunk may pass those of the
    same paths with the filters off by the one front-end launch alone (and,
    in the batched chunk, by the rms's launches, which its MFCC prologue
    takes without filters): no torch kernel of the filters is left."""
    import copy

    from rustpotter_tpu_torch import AudioFmt, RustpotterConfig, SampleFormat, ScoreMode
    from rustpotter_tpu_torch.synthetic import (
        bench_utterances,
        build_bench_wakeword,
        correctness_stream,
    )

    B = BENCH_STREAMS
    ww, utterance = build_bench_wakeword(device=dev)
    F = max(len(m) for m in ww.samples_features.values())
    base = RustpotterConfig()
    base.detector.score_mode = ScoreMode.MAX
    base.detector.avg_threshold = 0.2
    rng = np.random.default_rng(0)
    summary = {}

    # dtw_filters: __graft_entry__.entry()'s filters (default 80-400 Hz band)
    cfg = copy.deepcopy(base)
    cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = True
    stream0 = correctness_stream(F, utterance)
    noise = rng.normal(0, 0.05, (B, 480)).astype(np.float32)
    noise[1] *= np.float32(0.062 / 0.05)  # gain 0.9: the steps' 0x3F666667
    cell, bq = front_batched(dev, card, "dtw_filters", ww, cfg, stream0, noise, ref_cfg=base)
    record["biquad"]["launches"] = bq
    summary.update(cell)
    summary.update(front_step(dev, card, "dtw_filters", ww, cfg, stream0, noise, ref_cfg=base))
    summary.update(front_rustpotter(dev, card, "dtw_filters", ww, cfg, stream0, 1))

    # dtw_48k: tools/bench_suite.py's scenario, the utterance synthesized at 48 kHz
    cfg = copy.deepcopy(base)
    cfg.fmt = AudioFmt(sample_rate=48000, sample_format=SampleFormat.F32)
    stream48 = correctness_stream(F, bench_utterances(F, 48000)[0], 1440)
    noise48 = rng.normal(0, 0.05, (B, 1440)).astype(np.float32)
    cell, _ = front_batched(dev, card, "dtw_48k", ww, cfg, stream48, noise48,
                            in_graph_resample=True)
    summary.update(cell)
    cfg.fmt = AudioFmt(sample_rate=48000, sample_format=SampleFormat.I16)
    frames16 = np.clip(np.round(stream48 * 32767.0), -32768, 32767).astype(np.int16)
    summary.update(front_rustpotter(dev, card, "dtw_48k", ww, cfg, frames16, 0))
    return summary


# ------------------------------------------------------------- training

TRAIN_FILES, TEST_FILES = 64, 16
CHECK_EPOCHS = 200  # card against CPU: SGD carries the rounding forward
TRAIN_EARLY = dict(rtol=2e-4, atol=2e-5)  # tests/test_training_torch_crosscheck.py
TRAIN_LATE = dict(rtol=5e-3, atol=5e-4)
PROFILED_EPOCHS = 10  # one chunk of test_epochs
GRAPH_TIMED_CHUNKS = 20  # replays inside the CUDA events of the graph's device time
# calls of a chunk in each profile that holds a replay's kernels to the eager
# chunk's: a record the profiler drops or takes in moves a kernel's launches
# per call by 1/PROFILED_CALLS, so at 3 calls two in one reading rounded to
# another whole launch
PROFILED_CALLS = 10
# F3: paths whose kernel asks for more than 48 KB of shared memory at C = 16
# (kind, band, bundle options): K2 from w = 9, K3 at every band, K1 from w = 10
F3_PATHS = (("make_step K2", 9, {}), ("make_step K3", 5, {"dtw_fused": False}),
            ("BatchedDetector K1", 10, {}))
F3_STREAMS = 4


def f3_check(ww, utterance):
    """F3 on two cards: each path of F3_PATHS on cuda:0, then on cuda:1 with
    card 0 current, in this process, each held to a CPU run's events
    (`match_events`). Returns {path: whether cuda:1's events equal cuda:0's
    bit for bit}."""
    import copy

    import torch

    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.bundle import build_bundle
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.state import init_state
    from rustpotter_tpu_torch.runtime.stream_step import make_step
    from rustpotter_tpu_torch.synthetic import correctness_stream

    base = RustpotterConfig()
    base.detector.score_mode = ScoreMode.MAX
    base.detector.avg_threshold = 0.2
    noise_np = np.random.default_rng(0).normal(0, 0.05, (F3_STREAMS, 480)).astype(np.float32)
    same = {}
    for what, band, opts in F3_PATHS:
        cfg = copy.deepcopy(base)
        cfg.detector.band_size = band
        evs = {}
        for d in ("cuda:0", "cuda:1", "cpu"):
            dev = torch.device(d)
            if what.startswith("BatchedDetector"):
                det = BatchedDetector([("w", ww)], cfg, batch_size=F3_STREAMS, device=dev)
                static, states = det.static, det.init_states()
                process = lambda s, x, det=det: det.process_chunk(det.params, s, x)
            else:
                static, params = build_bundle([("w", ww)], cfg, dev, **opts)
                step = GraphedStep(make_step(static))
                states = init_state(static, F3_STREAMS, dev)
                process = lambda s, x, step=step, params=params: step(params, s, x)
            stream0 = torch.tensor(correctness_stream(static.max_mfcc_frames, utterance),
                                   device=dev)
            evs[d] = run_correctness(process, states, stream0,
                                     torch.tensor(noise_np, device=dev))
        assert torch.cuda.current_device() == 0
        for d in ("cuda:0", "cuda:1"):
            n, worst = match_events(evs[d], evs["cpu"], f"F3 {what} on {d}")
        same[what] = all(
            np.array_equal(a.view(np.int32), b.view(np.int32)) if a.dtype == np.float32
            else np.array_equal(a, b) for a, b in zip(evs["cuda:1"], evs["cuda:0"]))
        log(f"F3 {what} (w = {band}): cuda:0 and then cuda:1 give the cpu run's events "
            f"({n} events, max|d score| {worst:.3e}); cuda:1 bit-equal to cuda:0 "
            f"{same[what]}")
    return same


def eager_fit(tr, host, x, y, learning_rate, epochs, chunk):
    """The eager yardstick of `trainer.fit` (verbose off, epochs a multiple of
    chunk): `sgd_epochs` called for every chunk, the losses read per chunk.
    Returns the trained [(weight, bias), ...] and the losses."""
    import torch

    assert epochs % chunk == 0, (epochs, chunk)
    consts = (y, torch.tensor(learning_rate, dtype=torch.float32, device=x.device))
    state = tr.epoch_state(host, chunk, x.device)
    history = []
    for _ in range(epochs // chunk):
        state, (losses,) = tr.sgd_epochs(consts, state, x)
        history += losses.tolist()
    return tr.layers(state), history


def train_phase(dev, card):
    """NN training (see the module docstring, phase 8)."""
    import gc
    import tempfile

    import torch

    from rustpotter_tpu_torch import RustpotterConfig, load_wakeword, save_wakeword
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.synthetic import (
        NN_TRAIN_SIZE,
        bench_utterances,
        build_bench_wakeword,
        correctness_stream,
        training_wavs,
    )
    from rustpotter_tpu_torch.utils.profiling import profiled_kernels, split_copies
    from rustpotter_tpu_torch.wakewords import trainer as tr
    from rustpotter_tpu_torch.wakewords.files import ModelType
    from rustpotter_tpu_torch.wakewords.nn import init_params

    samples = training_wavs(NN_TRAIN_SIZE, TRAIN_FILES, seed=0)
    tests = training_wavs(NN_TRAIN_SIZE, TEST_FILES, seed=1)
    opts = tr.WakewordModelTrainOptions(epochs=CHECK_EPOCHS)
    runs = {}
    for d in (dev, "cpu"):
        hist = {}
        t0 = time.perf_counter()
        model = tr.train_from_buffers(opts, samples, tests, seed=0, verbose=False,
                                      history_out=hist, device=d)
        runs[str(d)] = (model, hist, time.perf_counter() - t0)
    (mg, hg, sg), (mc, hc, sc) = runs[str(dev)], runs["cpu"]
    dims = [mg.weights[f"ln{i}.weight"].dims for i in (1, 2, 3)]
    assert dims == [[56, 2688], [28, 56], [2, 28]], dims
    assert mg.labels == mc.labels == ["bench", "none"] and mg.train_size == NN_TRAIN_SIZE
    # the epochs graphed (`fit`) against eager on the card: the same kernels,
    # the same bits
    labeled, _ = tr._get_mfccs_labeled(samples, [], True, 16, dev)
    test_labeled, _ = tr._get_mfccs_labeled(tests, ["bench", "none"], False, 16, dev)
    x, y = (torch.tensor(a, device=dev) for a in tr._stack(labeled, NN_TRAIN_SIZE * 16))
    xt, yt = (torch.tensor(a, device=dev) for a in tr._stack(test_labeled, NN_TRAIN_SIZE * 16))
    host = init_params(ModelType.MEDIUM, NN_TRAIN_SIZE * 16, 16, 2, 0)
    pg, loss_g = tr.fit(host, x, y, xt, yt, opts.learning_rate, CHECK_EPOCHS,
                        opts.test_epochs, verbose=False)
    pe, loss_e = eager_fit(tr, host, x, y, opts.learning_rate, CHECK_EPOCHS, opts.test_epochs)
    assert np.array_equal(np.float32(loss_g).view(np.int32), np.float32(loss_e).view(np.int32))
    assert np.array_equal(np.float32(loss_g), np.float32(hg["loss"]))  # fit is the entry's
    for (wg, bg), (we, be) in zip(pg, pe):
        assert torch.equal(wg.detach().view(torch.int32), we.detach().view(torch.int32))
        assert torch.equal(bg.detach().view(torch.int32), be.detach().view(torch.int32))
    acc_g, acc_e = float(tr.accuracy(pg, xt, yt)), float(tr.accuracy(pe, xt, yt))
    assert acc_g == acc_e == hg["test_accuracy"], (acc_g, acc_e)
    log(f"train: {CHECK_EPOCHS} epochs graphed (a CUDA graph of {opts.test_epochs} epochs "
        f"replayed per chunk) equal the eager epochs on the card bit for bit: losses, "
        f"weights, test accuracy {acc_g:.4f}")
    lg, lc = np.array(hg["loss"]), np.array(hc["loss"])
    np.testing.assert_allclose(lg[:10], lc[:10], **TRAIN_EARLY, err_msg="loss, epochs 1-10")
    np.testing.assert_allclose(lg, lc, **TRAIN_LATE, err_msg="loss")
    worst_w = 0.0
    for k in mc.weights:
        a, b = mg.weights[k].to_numpy(), mc.weights[k].to_numpy()
        np.testing.assert_allclose(a, b, **TRAIN_LATE, err_msg=k)
        worst_w = max(worst_w, float(np.abs(a - b).max()))
    assert hg["test_accuracy"] == hc["test_accuracy"], (hg["test_accuracy"], hc["test_accuracy"])
    log(f"train: MEDIUM 2688 -> 56 -> 28 -> 2, {TRAIN_FILES} + {TEST_FILES} files, "
        f"{CHECK_EPOCHS} epochs on the card ({sg:.3f} s, graphed) and the cpu ({sc:.3f} s): "
        f"loss {lg[0]:.6f} -> {lg[-1]:.6f} (cpu {lc[-1]:.6f}), max|d loss| "
        f"{float(np.abs(lg - lc).max()):.3e}, max|d weight| {worst_w:.3e}, test accuracy "
        f"{hg['test_accuracy']:.4f} on both, rms_level {mg.rms_level:.6f} / {mc.rms_level:.6f}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.rpw")
        save_wakeword(mg, path)
        back = load_wakeword(path)
    assert back.labels == mg.labels and back.train_size == mg.train_size
    for k, v in mg.weights.items():
        assert back.weights[k].bytes == v.bytes and back.weights[k].dims == v.dims, k
    log("train: save_wakeword / load_wakeword give the weights back byte for byte")

    stream0 = correctness_stream(NN_TRAIN_SIZE, bench_utterances(100)[0])
    noise = np.random.default_rng(0).normal(0, 0.05, (4, 480)).astype(np.float32)
    events = {}
    for d in (dev, "cpu"):
        det = BatchedDetector([("t", back)], RustpotterConfig(), batch_size=4, device=d)
        events[str(d)] = run_correctness(
            lambda s, f: det.process_chunk(det.params, s, f), det.init_states(),
            torch.tensor(stream0, device=d), torch.tensor(noise, device=d))
    n_events, worst = match_events(events[str(dev)], events["cpu"], "trained model",
                                   NN_RTOL, NN_ATOL)
    fired0 = int(events[str(dev)][0][:, 0].sum())
    log(f"train: the trained model served at B=4 gives the cpu run's events ({n_events} "
        f"events, max|d score| {worst:.3e}); stream 0 fired {fired0}x, streams 1-3 "
        f"{int(events[str(dev)][0][:, 1:].sum())}x")

    # the MFCC extraction of the 80 WAVs (M2a) graphed against eager, the
    # bench templates built from WAVs, then the reference's 1000 epochs
    # through the entry point (graphed), on the host clock
    m2a = extraction_phase(dev, card, list(samples.values()) + list(tests.values()))
    full = tr.WakewordModelTrainOptions()
    hist = {}
    t0 = time.perf_counter()
    tr.train_from_buffers(full, samples, tests, seed=0, verbose=False, history_out=hist,
                          device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    # the epochs alone (1000 epochs, the losses read per chunk of 10), in turns
    # eager (`eager_fit`) / graph (`fit`, one capture per call) / graph / eager
    turns = {"eager": [], "graph": []}
    reserved = []
    for which in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "graph":
            tr.fit(host, x, y, xt, yt, full.learning_rate, full.epochs, full.test_epochs,
                   verbose=False)
        else:
            eager_fit(tr, host, x, y, full.learning_rate, full.epochs, full.test_epochs)
        torch.cuda.synchronize()
        turns[which].append((time.perf_counter() - t0) * 1e3 / full.epochs)
        gc.collect()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved() / 2**20)
    (e1, e2), (g1, g2) = turns["eager"], turns["graph"]
    log(f"train [{card}]: the epochs alone, host ms per epoch over {full.epochs} epochs in "
        f"turns eager {e1:.4f} / graph {g1:.4f} / graph {g2:.4f} / eager {e2:.4f} (losses "
        f"read per {full.test_epochs}; a graphed call's one eager chunk and capture "
        f"included); memory reserved after each call and empty_cache "
        f"{' / '.join(f'{m:.1f}' for m in reserved)} MiB")

    # one chunk of PROFILED_EPOCHS epochs: the graph's device time by CUDA
    # events around replays, and a replay's kernels against the eager chunk's
    consts = (y, torch.tensor(full.learning_rate, dtype=torch.float32, device=dev))
    step = GraphedStep(tr.sgd_epochs)
    sgr = tr.epoch_state(host, PROFILED_EPOCHS, dev)
    sea = tr.epoch_state(host, PROFILED_EPOCHS, dev)
    calls = {"replay": 0, "eager": 0}

    def replay():
        calls["replay"] += 1
        return step(consts, sgr, x)

    def eager():
        calls["eager"] += 1
        return tr.sgd_epochs(consts, sea, x)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()  # eager, then the capture
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    one_replay_ms = (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(GRAPH_TIMED_CHUNKS):
        replay()
    b.record()
    torch.cuda.synchronize()
    graph_dev_ms = a.elapsed_time(b) / (GRAPH_TIMED_CHUNKS * PROFILED_EPOCHS)
    rows_e = device_kernels(eager, 3)
    rows_g = device_kernels(replay, 3)
    dev_ms = sum(r[0] for r in rows_e) / PROFILED_EPOCHS
    launches = sum(r[1] for r in rows_e) / PROFILED_EPOCHS
    gdev_ms = sum(r[0] for r in rows_g) / PROFILED_EPOCHS
    glaunches = sum(r[1] for r in rows_g) / PROFILED_EPOCHS
    got = profiled_kernels(replay, PROFILED_CALLS)
    want = profiled_kernels(eager, PROFILED_CALLS)
    assert step.captures == 1
    (kg, cg), (ke, ce) = split_copies(got), split_copies(want)
    assert kg == ke, {k: (kg.get(k), ke.get(k)) for k in kg.keys() | ke.keys()
                      if kg.get(k) != ke.get(k)}
    extra = cg - ce
    assert extra == 2, (cg, ce)  # outside the graph: the input's copy and a clone
    while calls["eager"] < calls["replay"]:
        eager()
    for ga, ea in zip(sgr, sea):  # as many chunks, the same bits
        assert torch.equal(ga.detach().view(torch.int32), ea.detach().view(torch.int32))
    log(f"train: {full.epochs} epochs through train_from_buffers (graphed) in "
        f"{train_s:.4f} s host clock ({train_s * 1e3 / full.epochs:.4f} ms per epoch with "
        f"the MFCCs; final loss {hist['loss'][-1]:.6f}, test accuracy "
        f"{hist['test_accuracy']:.4f}; its MFCC extraction graphed); a graphed call's "
        f"first chunk (eager, then the capture) {first_ms:.4f} ms against "
        f"{one_replay_ms:.4f} ms for a synchronized replay; the graph's device "
        f"time {graph_dev_ms:.4f} ms per epoch (CUDA events around {GRAPH_TIMED_CHUNKS} "
        f"replays of {PROFILED_EPOCHS} epochs with their copies); profiled, a replay "
        f"{gdev_ms:.4f} ms in {glaunches:.1f} launches per epoch, the eager chunk "
        f"{dev_ms:.4f} ms in {launches:.1f} ({card})")
    log(f"train: profiled, a replay runs the eager chunk's {len(ke)} device kernels "
        f"({sum(ke.values()):.1f} per chunk), each as often, and its {ce:.0f} copies plus "
        f"{extra:.0f} outside the graph (the input and the losses' clone); final weights "
        f"bit-equal")
    if not rows_e:
        log("train: the profiler recorded no device time: device ms per epoch not measured")
    for ms, count, name in rows_e[:PROFILE_ROWS]:
        log(f"profile: {ms / PROFILED_EPOCHS:9.4f} ms/epoch  {count / PROFILED_EPOCHS:5.1f} "
            f"launches/epoch  {name[:110]}")

    if torch.cuda.device_count() >= 2:
        ww, utterance = build_bench_wakeword(device=dev)
        f3 = f3_check(ww, utterance)
        f3_result = f"passed (cuda:1 bit-equal to cuda:0: {f3})"
    else:
        f3_result = "not run (one card)"
    log(f"F3 (the shared-memory opt-in on a second card): {f3_result}")
    return {"train_ms_per_epoch": train_s * 1e3 / full.epochs,
            "train_eager_ms_per_epoch": turns["eager"],
            "train_graph_ms_per_epoch": turns["graph"],
            "train_graph_device_ms_per_epoch": graph_dev_ms,
            "train_first_chunk_ms": first_ms, "train_reserved_mib": reserved,
            "train_replay_device_ms_per_epoch": gdev_ms,
            "train_replay_launches_per_epoch": glaunches,
            "train_device_ms_per_epoch": dev_ms, "train_launches_per_epoch": launches,
            "train_stream0_fired": fired0, "train_f3": f3_result, **m2a}


def eager_pipeline(samples, num_coefficients, device=None):
    """`offline.mfcc_pipeline` without its graphs: the wrapped function,
    `mfcc_features`, called directly."""
    import torch

    from rustpotter_tpu_torch.device import resolve_device
    from rustpotter_tpu_torch.mfcc import offline

    x = torch.as_tensor(np.asarray(samples, np.float32), device=resolve_device(device))
    return offline.mfcc_features(x, num_coefficients).cpu().numpy()


def extraction_phase(dev, card, wavs):
    """M2a (see the module docstring, phase 8): the extraction of `wavs`
    (the 80 training and test WAVs, 168 frames each) in turns eager /
    graphed / graphed / eager, each split into the host encoder and the
    device pipeline (host clock; the pipeline's time ends in its read of the
    features), bit for bit; the captures of the graphed turns; launches and
    device ms per WAV of the eager pipeline and of a replay (torch.profiler);
    then the bench wakeword built from WAV bytes of the 5 bench utterances,
    graphed against eager bit for bit and against a device="cpu" build."""
    import gc

    import torch

    from rustpotter_tpu_torch.constants import DETECTOR_INTERNAL_SAMPLE_RATE
    from rustpotter_tpu_torch.mfcc import offline
    from rustpotter_tpu_torch.synthetic import bench_utterances
    from rustpotter_tpu_torch.utils.profiling import profiled_kernels
    from rustpotter_tpu_torch.utils.wav import wav_bytes
    from rustpotter_tpu_torch.wakewords.builder import build_wakeword_ref_from_buffers

    n = 17  # mfcc_size 16, coefficient 0 dropped
    offline.GRAPHS.clear()
    captures = offline.GRAPHS.captures

    def extract(pipeline):
        host = device = 0.0
        outs = []
        for wav in wavs:
            t0 = time.perf_counter()
            x, _ = offline.encode_wav(wav)
            t1 = time.perf_counter()
            outs.append(pipeline(x, n, dev))
            host, device = host + t1 - t0, device + time.perf_counter() - t1
        return host * 1e3, device * 1e3, outs

    turns = []
    for which in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        turns.append((which, *extract(eager_pipeline if which == "eager" else
                                      offline.mfcc_pipeline)))
    made = offline.GRAPHS.captures - captures
    want = [o.view(np.int32) for o in turns[0][3]]
    for which, _, _, outs in turns[1:]:
        assert all(np.array_equal(o.view(np.int32), w) for o, w in zip(outs, want)), which
    assert made == 1, made
    x, _ = offline.encode_wav(wavs[0])
    prof = {"eager": lambda: eager_pipeline(x, n, dev),
            "replay": lambda: offline.mfcc_pipeline(x, n, dev)}
    kernels = {k: profiled_kernels(f, 5) for k, f in prof.items()}
    extra = {k: v - kernels["eager"].get(k, 0) for k, v in kernels["replay"].items()
             if v != kernels["eager"].get(k, 0)}
    dev_ms = {k: sum(r[0] for r in device_kernels(f, 5)) for k, f in prof.items()}
    # what the one graph's pool holds: the reserved memory with it and without
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    offline.GRAPHS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    pool_mib = (held - torch.cuda.memory_reserved()) / MIB
    log(f"M2a extraction of {len(wavs)} WAVs of {len(want[0])} frames [{card}]: host ms in "
        f"turns " + " / ".join(f"{w} {h + d:.4f} (host encoder {h:.4f} + pipeline {d:.4f})"
                                for w, h, d, _ in turns)
        + f"; graphed equals eager bit for bit on every WAV; {made} capture, whose graph "
        f"held {pool_mib:.1f} MiB reserved (after empty_cache, with it and without)")
    log(f"M2a per WAV: the eager pipeline runs {sum(kernels['eager'].values())} device "
        f"kernels and copies ({dev_ms['eager']:.4f} ms device busy), a replay "
        f"{sum(kernels['replay'].values())} ({dev_ms['replay']:.4f} ms); the replay's "
        f"more: {extra}; eager: {kernels['eager']}")

    buffers = {f"s{i}.wav": wav_bytes(w, DETECTOR_INTERNAL_SAMPLE_RATE)
               for i, w in enumerate(bench_utterances(100))}
    offline.GRAPHS.clear()
    captures = offline.GRAPHS.captures
    built = {"graph": build_wakeword_ref_from_buffers("bench", buffers, 16, device=dev)}
    made_build = offline.GRAPHS.captures - captures
    real = offline.mfcc_pipeline
    offline.mfcc_pipeline = eager_pipeline
    try:
        built["eager"] = build_wakeword_ref_from_buffers("bench", buffers, 16, device=dev)
    finally:
        offline.mfcc_pipeline = real
    built["cpu"] = build_wakeword_ref_from_buffers("bench", buffers, 16, device="cpu")
    g, e, c = built["graph"], built["eager"], built["cpu"]
    lengths = [len(g.samples_features[k]) for k in buffers]
    for k in buffers:
        assert np.array_equal(g.samples_features[k].view(np.int32),
                              e.samples_features[k].view(np.int32)), k
        np.testing.assert_allclose(g.samples_features[k], c.samples_features[k],
                                   rtol=MFCC_RTOL, atol=MFCC_ATOL, err_msg=k)
    assert np.array_equal(g.avg_features.view(np.int32), e.avg_features.view(np.int32))
    np.testing.assert_allclose(g.avg_features, c.avg_features, rtol=MFCC_RTOL, atol=MFCC_ATOL)
    assert g.rms_level == e.rms_level == c.rms_level
    worst = max(float(np.abs(g.samples_features[k] - c.samples_features[k]).max())
                for k in buffers)
    log(f"M2a builder: the bench wakeword from WAV bytes of the 5 bench utterances "
        f"({lengths} frames: the encoder keeps whole 30 ms chunks), graphed equals eager bit "
        f"for bit (templates, avg, rms), {made_build} capture (a repeated length), and the "
        f"cpu build at rtol {MFCC_RTOL} / atol {MFCC_ATOL} (max|d| {worst:.3e})")
    return {"m2a_turns_ms": [(w, h, d) for w, h, d, _ in turns], "m2a_captures": made,
            "m2a_launches_per_wav": {k: sum(v.values()) for k, v in kernels.items()},
            "m2a_device_ms_per_wav": dev_ms, "m2a_builder_captures": made_build,
            "m2a_graph_pool_mib": pool_mib}


# ------------------------------------------------------------- sharding

GATHER_CALLS = 200


def shard_phase(dev, card):
    """Stream sharding over NCCL (see the module docstring, phase 9)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.parallel.collectives import (
        fleet_detection_count,
        gather_detections,
    )
    from rustpotter_tpu_torch.parallel.dryrun import dryrun_multigpu
    from rustpotter_tpu_torch.parallel.mesh import make_stream_group, multihost_initialize
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk
    from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

    B = BENCH_STREAMS
    ww, utterance = build_bench_wakeword(device=dev)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    noise = torch.tensor(np.random.default_rng(0).normal(0, 0.05, (B, 480)).astype(np.float32),
                         device=dev)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        # one process drives one card: the world is 1 rank here; several
        # cards run one process each (dryrun_multigpu below)
        multihost_initialize(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0, device=dev)
        try:
            sharding = make_stream_group()
            dets = {
                "sharded": BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev,
                                           sharding=sharding),
                "unsharded": BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev),
            }
            assert dets["sharded"].local_batch == B
            stream0 = torch.tensor(
                correctness_stream(dets["sharded"].static.max_mfcc_frames, utterance),
                device=dev)
            n_chunks = stream0.shape[0]
            events = {}
            for name, det in dets.items():
                states = det.init_states()
                evs = []
                reset_counts()
                for t in range(n_chunks):
                    frames = noise.clone()
                    frames[0] = stream0[t]
                    states, ev = det.process_chunk(det.params, states, frames)
                    evs.append([f.clone() for f in ev])
                torch.cuda.synchronize()
                k1 = read_counts()["fused_dtw_v4"]
                assert k1 == n_chunks, (name, k1, n_chunks)
                events[name] = evs
            for t, (a, b) in enumerate(zip(events["sharded"], events["unsharded"])):
                for f, g in zip(a, b):
                    if not bits_equal(f, g):
                        raise AssertionError(f"sharded chunk {t} differs from the unsharded one")
            # the sharded detector's graph against its eager chunk
            sharded = dets["sharded"]
            eager = make_batched_chunk(sharded.static)
            _, _, same = graph_pass(
                "shard sharded", lambda s, f: sharded.process_chunk(sharded.params, s, f),
                lambda s, f: eager(sharded.params, s, f), sharded.init_states(),
                sharded.init_states(), stream0, noise)
            summary["sharded_graph_bit_equal"] = same
            fired = torch.stack([ev[0] for ev in events["sharded"]])
            fired0 = int(fired[:, 0].sum())
            assert fired0 >= 1, "correctness guard: stream 0 did not fire in the sharded run"
            t_fire = int(fired[:, 0].nonzero()[0])
            ev = events["sharded"][t_fire]
            g_fired, g_score = gather_detections(sharding, ev[0], ev[2])
            count = fleet_detection_count(sharding, ev[0])
            assert bits_equal(g_fired, ev[0]) and bits_equal(g_score, ev[2])
            assert int(count) == int(ev[0].sum()), (int(count), int(ev[0].sum()))
            log(f"shard: world 1 ({dist.get_backend()}), B={B}: correctness pass of "
                f"{n_chunks} chunks bit-equal to the unsharded detector (every event field); "
                f"stream 0 fired {fired0}x; K1 {n_chunks} launches in each run; gather and "
                f"count at chunk {t_fire} return the local values (count {int(count)})")

            # host clock per chunk, in turns: unsharded, sharded, sharded, unsharded
            times = {"sharded": [], "unsharded": []}
            for name in ("unsharded", "sharded", "sharded", "unsharded"):
                det = dets[name]
                _, windows = timed_windows(lambda s, f: det.process_chunk(det.params, s, f),
                                           det.init_states(), noise)
                times[name] += [w / TIMED_CHUNKS * 1e3 for w in windows]
            _, ev = dets["sharded"].process_chunk(dets["sharded"].params,
                                                  dets["sharded"].init_states(), noise)
            secs = []
            for _ in range(GATHER_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fleet_detection_count(sharding, ev.fired)
                gather_detections(sharding, ev.fired, ev.score)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            gather_us = float(np.median(secs)) * 1e6
            for name in ("unsharded", "sharded"):
                t = times[name]
                log(f"shard: {name} {float(np.median(t)):.4f} ms per chunk host clock, median "
                    f"of {len(t)} windows of {TIMED_CHUNKS} chunks (range {min(t):.4f}-"
                    f"{max(t):.4f}; {card})")
                summary[f"{name}_chunk_ms"] = float(np.median(t))
            log(f"shard: gather_detections + fleet_detection_count {gather_us:.2f} us per "
                f"chunk (median of {GATHER_CALLS}, range {min(secs) * 1e6:.2f}-"
                f"{max(secs) * 1e6:.2f})")
            summary["gather_count_us"] = gather_us
        finally:
            dist.destroy_process_group()

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    dry = dryrun_multigpu(n, "cuda", timeout_s=300)
    log(f"shard: dryrun_multigpu({n}, 'cuda') in {time.perf_counter() - t0:.3f} s: "
        + json.dumps(dry))
    return summary

# ------------------------------------------------------------------ main

def timed_phase(phase, *args):
    """phase(*args), its host seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from rustpotter_tpu_torch import _build

    card = card_line()
    log(card)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    builds = [(src, {"RP_C": c, "RP_W": 5}) for src in SOURCES_C for c in (8, 16)]
    builds += [(src, {"RP_C": 16, "RP_W": w}) for src, w in WIDE]
    builds += [("banded_dtw.cu", {"RP_W": w}) for w in K3_BANDS]
    builds += [("fma_probe.cu", {}), ("biquad.cu", {}), ("ingest.cpp", {})]
    with ThreadPoolExecutor(len(builds)) as ex:
        list(ex.map(lambda b: _build.build(*b), builds))
    log(f"build: {len(builds)} libraries (kernel variants and the host ingest library) in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, d in builds:
        for line in _build.build_log(src, d).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {src} {d}: {line.strip()}")

    record = {}
    for phase in (kernel_phase, k2_phase, k3_phase, k4_phase, k5_phase, probe_phase):
        timed_phase(phase, dev, record)
    bq = timed_phase(biquad_phase, dev, record)
    bq.update(timed_phase(mfcc_front_phase, dev, record))
    summary = timed_phase(slice_phase, dev, record)
    summary.update(bq)
    summary.update(timed_phase(per_shift_phase, dev, record))
    summary.update(timed_phase(tools_phase, dev, record))
    summary.update(timed_phase(nn_phase, dev, card, record))
    summary.update(timed_phase(front_phase, dev, card, record))
    summary.update(timed_phase(train_phase, dev, card))
    summary.update(timed_phase(shard_phase, dev, card))
    log(f"replays_run: {REPLAY_PROFILES['paths']} graphed paths profiled in "
        f"{REPLAY_PROFILES['s']:.1f} s")
    log(json.dumps({"card": card, **summary}))
    if not record["fused_dtw_v2_column"]["launches"]:
        raise AssertionError("the F1 make_step pass did not launch K4's column form")
    log(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
