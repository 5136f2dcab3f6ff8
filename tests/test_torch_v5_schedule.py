"""V5's schedule (csrc/fma_probe.cu, probe_sload) on the CPU: a numpy
transcription of the kernel's lane map and rep loop, held against the plain
version `fma_probe.plain("sload")`.

The transcription follows the .cu: block g of a grid of one block per tile
takes tile g, and its thread t lanes t + SLOAD_BLOCK * j (j < SLOAD_LANES),
with SLOAD_LANES and SLOAD_BLOCK evaluated from the .cu's constants by the
host C++ compiler. Rep r reads the min(S, 16) values of row r & 31 of s as
vectors of 4 (the LDS.128 at the row base (r & 31) * 16 and immediate
offsets), and step i feeds value i % 16 to every chain of the thread. It
also feeds `fma_probe.flops_per_step` a listing of the kernel's loop, so
that V5 counts 2 FLOPs per step.

Tolerance: none. The transcription rounds each product as the plain version
does, so the two agree bit for bit; the kernel fuses it (card tests).
"""
import re
from collections import Counter

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import _build
from rustpotter_tpu_torch.tools import fma_probe
from test_torch_k3_schedule import _cu_constants

TILE = 8 * 128


@pytest.fixture(scope="module")
def cu():
    """V5's grid constants as the .cu defines them."""
    return _cu_constants(fma_probe.SOURCE, ("TILE", "SLOAD_LANES", "SLOAD_BLOCK"), [0], 0)[0]


def test_v5_grid_constants_follow_the_cu(cu):
    assert (cu["SLOAD_LANES"], cu["SLOAD_BLOCK"]) == (fma_probe.SLOAD_LANES,
                                                      fma_probe.SLOAD_BLOCK)
    assert cu["TILE"] == TILE == cu["SLOAD_LANES"] * cu["SLOAD_BLOCK"]
    # one block of SLOAD_BLOCK threads per tile
    text = (_build.CSRC / fma_probe.SOURCE).read_text()
    assert re.search(r"case 4: probe_sload<S><<<\(unsigned\)tiles, SLOAD_BLOCK, 0, stream>>>",
                     text)


def lane_map(tiles, lanes, block):
    """(tile, lane) written by (block g, thread t, chain j), each (tiles,
    block, lanes)."""
    g, t, j = np.meshgrid(np.arange(tiles), np.arange(block), np.arange(lanes), indexing="ij")
    return g, t + block * j


@pytest.mark.parametrize("tiles", [1, 3, 133])
def test_v5_writes_every_lane_of_every_tile_once(cu, tiles):
    tile, lane = lane_map(tiles, cu["SLOAD_LANES"], cu["SLOAD_BLOCK"])
    assert lane.min() == 0 and lane.max() == TILE - 1
    counts = np.bincount((tile * TILE + lane).ravel(), minlength=tiles * TILE)
    assert counts.shape == (tiles * TILE,) and (counts == 1).all()
    # a thread's chains are different lanes, so each reads its own x[1]
    for g in range(tiles):
        for t in range(cu["SLOAD_BLOCK"]):
            assert len(set(lane[g, t])) == cu["SLOAD_LANES"]


def rep_loop(reps, streams):
    """The index into s (32 * 16, flat) of every step of the kernel's rep
    loop, in its order, and the rep and step it belongs to."""
    steps = []
    for r in range(reps):
        base = (r & 31) * 16
        v = [base + 4 * c + e for c in range(min(streams, 16) // 4) for e in range(4)]
        steps += [(r, i, v[i % 16]) for i in range(streams)]
    return steps


@pytest.mark.parametrize("reps", [13, 16, 31, 33, 2000])
@pytest.mark.parametrize("streams", [8, 32])
def test_v5_chains_take_the_plain_version_order(reps, streams):
    """Every chain of a thread takes every step (the loop has no remainder),
    in the plain version's (r, i) order, each with s[r & 31][i % 16]."""
    steps = rep_loop(reps, streams)
    assert [(r, i) for r, i, _ in steps] == [(r, i) for r in range(reps)
                                             for i in range(streams)]
    assert [k for *_, k in steps] == [(r & 31) * 16 + i % 16 for r in range(reps)
                                      for i in range(streams)]


@pytest.mark.parametrize("reps", [13, 33])
@pytest.mark.parametrize("streams", [8, 32])
def test_v5_transcription_matches_plain_version(cu, reps, streams):
    x, s = fma_probe.inputs("cpu")
    xn = x.numpy().reshape(-1, TILE)
    sn = s.numpy().ravel()
    tiles = 3
    tile, lane = lane_map(tiles, cu["SLOAD_LANES"], cu["SLOAD_BLOCK"])
    acc = xn[0][lane] * np.float32(0)
    wt = xn[1][lane]
    for _, _, k in rep_loop(reps, streams):
        acc = acc + sn[k] * wt  # the plain version's rounding: product, then sum
    out = np.full((tiles, TILE), np.nan, np.float32)
    out[tile, lane] = acc
    want = fma_probe.plain("sload", x, s, reps, streams).numpy().reshape(1, TILE)
    np.testing.assert_array_equal(out, np.broadcast_to(want, out.shape))


def _listing(streams):
    """A `cuobjdump -sass` listing of probe_sload<S>'s rep loop as the .cu
    compiles it: the row base, min(S, 16) // 4 LDS.128 and SLOAD_LANES * S
    FFMAs, the counter, compare and branch."""
    loads = min(streams, 16) // 4
    body = ["IMAD.SHL.U32 R4, R70, 0x40, RZ", "VIADD R70, R70, 0x1",
            "LOP3.LUT R72, R4, 0x7c0, RZ, 0xc0, !PT", "ISETP.GE.AND P0, PT, R70, R0, PT"]
    body += [f"LDS.128 R{64 + 4 * (c % 2)}, [R72+UR4+{hex(16 * c)}]" for c in range(loads)]
    body += [f"FFMA R{j}, R{64 + i % 8}, R{32 + j}, R{j}"
             for i in range(streams) for j in range(fma_probe.SLOAD_LANES)]
    top = 0x900
    lines = [f"        /*{top + 16 * k:04x}*/                   {ins} ;"
             for k, ins in enumerate(body)]
    lines.append(f"        /*{top + 16 * len(body):04x}*/              @!P0 BRA {hex(top)} ;")
    return ("\t\tFunction : _ZN12_GLOBAL__N_111probe_sloadILi%dEEEvNS_4ArgsE\n" % streams
            + "\n".join(lines) + "\n        /*f000*/                   EXIT ;\n")


@pytest.mark.parametrize("streams", [8, 32])
def test_v5_loop_counts_two_flops_per_step(streams):
    facts = fma_probe.rep_loop_facts(_listing(streams))[("sload", streams)]
    loads = facts["full_ops"]["LDS.128"]
    assert loads == min(streams, 16) // 4 and facts["ops"]["LDS"] == loads
    ops = fma_probe.loop_opcodes(_listing(streams))[("sload", streams)]
    assert ops == Counter(FFMA=fma_probe.SLOAD_LANES * streams)
    assert fma_probe.flops_per_step(ops, streams) == 2
    # tests/test_torch_cuda.py pins this ratio in the compiled loop
    assert ops["FFMA"] == fma_probe.sload_ffma_per_load(streams) * loads
