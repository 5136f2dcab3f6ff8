"""The benchmark's audio: the bench utterances and the fleet's streams.

The synthesis law is the JAX bench's (`bench.py` `build_bench_wakeword`,
`correctness_pass`), copied so that the program cannot move it:
  - utterance i of `frames[i]` MFCC frames: (frames + 3) * 160 samples of
    amplitude * sin(2 pi cumsum(f0 + (f1 - f0) t / t_end) / 16000) plus
    noise * N(0, 1) from numpy's default_rng(seeds[i]);
  - the correctness stream of a window of F frames: (F // 3 + 4) chunks of
    silence, the first utterance, then a silence tail of (F + F // 2 + 30)
    // 3 chunks, in whole 30 ms chunks of 480 samples.

A fleet of B streams (a traffic file's `streams`), in blocks of
`utterance_every` streams: each block holds one utterance stream, which plays
the correctness stream in a loop, and one near stream, which plays it with
the utterance's noise raised to a level drawn from the traffic file's
`near_noise` range (the same N(0, 1) draw, scaled), so that its DTW scores
peak a few hundredths under the threshold. Both sit at offsets inside their
block drawn from the seed, block 0's utterance stream at offset 0 (stream
0); each loop is padded with silence to a whole number of rings and starts
at a ring boundary drawn from the seed. Every other stream loops a ring of
`ring_chunks` chunks of noise * N(0, 1) over a chirp fragment whose
amplitude, length, start and end frequencies are drawn from the seed within
the traffic file's ranges. The ring is made on the card by a
`torch.Generator` seeded with the run's seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

RATE = 16000
CHUNK = 480
SHIFT = 160


def utterances(spec: dict) -> list:
    """The utterances of a wakeword's `utterances` entry (numpy float32)."""
    f0, f1 = spec["chirp_hz"]
    out = []
    for frames, seed in zip(spec["frames"], spec["seeds"]):
        n = (frames + 3) * SHIFT
        rng = np.random.default_rng(seed)
        t = np.arange(n) / float(RATE)
        sig = spec["amplitude"] * np.sin(
            2 * np.pi * np.cumsum(f0 + (f1 - f0) * t / t[-1]) / float(RATE)
        ) + spec["noise"] * rng.normal(size=n)
        out.append(sig.astype(np.float32))
    return out


def correctness_stream(F: int, utterance: np.ndarray) -> np.ndarray:
    """(chunks, 480): silence, the utterance, a silence tail."""
    s = np.concatenate([np.zeros((F // 3 + 4) * CHUNK, np.float32), utterance,
                        np.zeros(((F + F // 2 + 30) // 3) * CHUNK, np.float32)])
    n = len(s) // CHUNK
    return s[: n * CHUNK].reshape(n, CHUNK)


@dataclass
class Fleet:
    """The streams of a cell. `ring` (R, B, 480) on the card holds every
    noise stream's R chunks; `loops` (K, L, 480) the played loops (0: the
    correctness stream; 1..: the near streams'), each L = a whole number of
    rings long; `special` (U,) the streams that play a loop, `loop_of` (U,)
    which, `phase` (U,) the chunk each starts at; `utt` and `near` the
    utterance and near streams."""

    ring: torch.Tensor
    loops: torch.Tensor
    special: torch.Tensor
    loop_of: torch.Tensor
    phase: torch.Tensor
    utt: torch.Tensor
    near: torch.Tensor

    @property
    def R(self) -> int:
        return self.ring.shape[0]

    def special_chunks(self, first: int, count: int) -> torch.Tensor:
        """(count, U, 480): the loop streams' chunks first .. first + count - 1."""
        c = first + torch.arange(count, device=self.loops.device)
        pos = (self.phase[None, :] + c[:, None]) % self.loops.shape[1]
        return self.loops[self.loop_of[None, :], pos]

    def classes(self, streams) -> list:
        """Each stream's class: utterance, near or noise."""
        utt, near = set(self.utt.tolist()), set(self.near.tolist())
        return ["utterance" if s in utt else "near" if s in near else "noise" for s in streams]

    def stream_pcm(self, streams, n_chunks: int) -> torch.Tensor:
        """(S, n_chunks * 480): what each of `streams` was handed over
        chunks 0 .. n_chunks - 1."""
        rows = []
        c = torch.arange(n_chunks, device=self.ring.device)
        at = {int(u): i for i, u in enumerate(self.special.tolist())}
        for s in streams:
            if s in at:
                i = at[s]
                pcm = self.loops[self.loop_of[i], (self.phase[i] + c) % self.loops.shape[1]]
            else:
                pcm = self.ring[c % self.R, s]
            rows.append(pcm.reshape(-1))
        return torch.stack(rows)


def make_fleet(traffic: dict, B: int, F: int, spec: dict,
               gen: torch.Generator, device) -> Fleet:
    """`spec`: the utterances entry whose first utterance the loops play."""
    R = traffic["ring_chunks"]
    every = traffic["utterance_every"]
    frag = traffic["fragment"]
    lo = lambda k: float(frag[k][0])
    span = lambda k: float(frag[k][1]) - float(frag[k][0])
    u = torch.rand((5, B), generator=gen, device=device)
    amp = lo("amplitude") + span("amplitude") * u[0]
    dur = lo("seconds") + span("seconds") * u[1]
    start = u[2] * (R * CHUNK / RATE - dur)
    f0 = lo("start_hz") + span("start_hz") * u[3]
    f1 = lo("end_hz") + span("end_hz") * u[4]
    ring = torch.empty((R, B, CHUNK), device=device)
    for r in range(R):
        t = (r * CHUNK + torch.arange(CHUNK, device=device)) / RATE
        tau = t[None, :] - start[:, None]  # (B, 480)
        inside = (tau >= 0) & (tau < dur[:, None])
        phi = 2 * math.pi * (f0[:, None] * tau + (f1 - f0)[:, None] * tau * tau / (2 * dur[:, None]))
        chirp = torch.where(inside, amp[:, None] * torch.sin(phi), 0.0)
        ring[r] = traffic["noise"] * torch.randn((B, CHUNK), generator=gen, device=device) + chirp

    if every < 2 or B % every:
        raise ValueError("streams must be a whole number of blocks of utterance_every >= 2")
    blocks = B // every
    # two distinct offsets per block; block 0's utterance stream is stream 0
    a = (torch.rand((blocks,), generator=gen, device=device) * every).long()
    b = (torch.rand((blocks,), generator=gen, device=device) * (every - 1)).long()
    a[0] = 0
    b = b + (b >= a).long()
    base = every * torch.arange(blocks, device=device)
    utt, near = base + a, base + b
    lo_n, hi_n = (float(x) for x in traffic["near_noise"])
    levels = lo_n + (hi_n - lo_n) * torch.rand((blocks,), generator=gen, device=device)
    loops = [correctness_stream(F, utterances(spec)[0])]
    loops += [correctness_stream(F, utterances(dict(spec, noise=float(v)))[0])
              for v in levels.tolist()]
    L = -(-len(loops[0]) // R) * R
    loops = np.stack([np.concatenate([lp, np.zeros((L - len(lp), CHUNK), np.float32)])
                      for lp in loops])
    phase = R * torch.randint(0, L // R, (2 * blocks,), generator=gen, device=device)
    loop_of = torch.cat([torch.zeros(blocks, dtype=torch.long, device=device),
                         1 + torch.arange(blocks, device=device)])
    return Fleet(ring, torch.tensor(loops, device=device), torch.cat([utt, near]), loop_of,
                 phase, utt, near)
