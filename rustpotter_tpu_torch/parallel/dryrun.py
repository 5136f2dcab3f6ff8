"""A dry run of the stream-parallel runtime over `n` ranks.

The counterpart of `__graft_entry__.dryrun_multichip`: `dryrun_multigpu(n,
device_type)` spawns `n` ranks (gloo ranks on the CPU, or one rank per card
over NCCL), and each rank

  - builds a sharded `BatchedDetector` over a synthetic DTW + NN wakeword
    pair (2 streams per rank), runs one chunk of seeded noise on its block,
    counts the fleet's detections (`fleet_detection_count`) and gathers the
    events (`gather_detections`);
  - takes one data-parallel SGD step of a TINY classifier: each rank's loss
    is the NLL sum of its block of the batch divided by the global N, the
    gradients are all-reduced (SUM), and the step must equal the
    single-process step on the whole batch (rtol 1e-6).

`sharded_sequence` and `gather_blocks` run a sharded detector over given
frames and the collectives over given blocks on `n` ranks, for the tests.
The rank functions live here, in a module that imports neither JAX nor a
test file, so that spawned ranks load only the port.

    python -m rustpotter_tpu_torch.parallel.dryrun 2 cpu
"""
from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import RustpotterConfig
from ..runtime.batch import BatchedDetector
from ..wakewords.files import ModelType, WakewordModel, WakewordRef
from ..wakewords.nn import forward, init_params, params_to_tensor_data
from .collectives import fleet_detection_count, gather_detections
from .mesh import make_stream_group, multihost_initialize

STREAMS_PER_RANK = 2
TRAIN_ROWS_PER_RANK = 4
LR = 0.01
DP_RTOL = 1e-6


def synthetic_wakewords(n_templates=5, frames=100, mfcc_size=16, train_size=60):
    """A DTW + NN wakeword pair from seeded numpy, no file fixtures: the
    port's copy of `__graft_entry__._synthetic_wakewords`."""
    rng = np.random.default_rng(0)
    feats = {
        f"sample_{i}.wav": rng.normal(0, 2, (frames - (i % 3) * 5, mfcc_size)).astype(
            np.float32
        )
        for i in range(n_templates)
    }
    avg = rng.normal(0, 2, (frames, mfcc_size)).astype(np.float32)
    ref = WakewordRef(
        name="synthetic", samples_features=feats, avg_features=avg, rms_level=0.05
    )
    nn = WakewordModel(
        labels=["none", "synthetic"],
        train_size=train_size,
        mfcc_size=mfcc_size,
        m_type=ModelType.TINY,
        weights=params_to_tensor_data(
            init_params(ModelType.TINY, train_size * mfcc_size, mfcc_size, 2)
        ),
        rms_level=0.05,
    )
    return [("ref", ref), ("nn", nn)]


def _sgd_step(params, x, y, n_global: int, lr: torch.Tensor, sharding=None):
    """One SGD step on (x, y): the NLL sum over the rows divided by
    n_global; with `sharding`, the loss and the gradients are all-reduced
    (SUM) first. Returns (new params, loss)."""
    flat = [p.clone().requires_grad_() for wb in params for p in wb]
    pairs = list(zip(flat[0::2], flat[1::2]))
    logp = torch.log_softmax(forward(pairs, x), dim=-1)
    loss = -torch.gather(logp, 1, y[:, None]).sum() / n_global
    grads = list(torch.autograd.grad(loss, flat))
    loss = loss.detach()
    if sharding is not None:
        for t in grads + [loss]:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=sharding.group)
    new = [(p - lr * g).detach() for p, g in zip(flat, grads)]
    return list(zip(new[0::2], new[1::2])), loss


def _dryrun_body(sharding, dev) -> dict:
    """The dry run on one rank (see the module docstring)."""
    out = {"rank": sharding.rank, "world": sharding.world, "device": str(dev)}

    # batched streaming detection, streams sharded over the ranks
    B = STREAMS_PER_RANK * sharding.world
    det = BatchedDetector(
        synthetic_wakewords(n_templates=3, frames=24, mfcc_size=8, train_size=16),
        RustpotterConfig(), batch_size=B, device=dev, sharding=sharding,
    )
    noise = np.random.default_rng(1).normal(0, 0.05, (B, 480)).astype(np.float32)
    frames = sharding.local(torch.tensor(noise, device=dev))
    _, ev = det.process_chunk(det.params, det.init_states(), frames)
    count = fleet_detection_count(sharding, ev.fired)
    g_fired, g_score = gather_detections(sharding, ev.fired, ev.score)
    if g_fired.shape != (B,) or g_score.shape != (B,):
        raise AssertionError(f"gathered {tuple(g_fired.shape)}, {tuple(g_score.shape)}")
    if int(count) != int(g_fired.sum()):
        raise AssertionError(f"count {int(count)} != gathered {int(g_fired.sum())}")
    if not torch.equal(sharding.local(g_score), ev.score):
        raise AssertionError("the gathered block of this rank is not its events")
    out.update(local_batch=det.local_batch, fleet_count=int(count),
               gathered=int(g_fired.numel()))

    # one data-parallel SGD step of a TINY classifier
    C, frames_nn, labels = 8, 16, 2
    N = TRAIN_ROWS_PER_RANK * sharding.world
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(0, 1, (N, frames_nn * C)).astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, labels, N), device=dev)
    params = [(torch.tensor(w, device=dev), torch.tensor(b, device=dev))
              for w, b in init_params(ModelType.TINY, frames_nn * C, C, labels)]
    lr = torch.tensor(LR, dtype=torch.float32, device=dev)
    dp, dp_loss = _sgd_step(params, sharding.local(x), sharding.local(y), N, lr, sharding)
    one, one_loss = _sgd_step(params, x, y, N, lr)
    worst = 0.0
    for (a, b), (c, d) in zip(dp, one):
        for got, want in ((a, c), (b, d)):
            torch.testing.assert_close(got, want, rtol=DP_RTOL, atol=0)
            worst = max(worst, float((got - want).abs().max()))
    torch.testing.assert_close(dp_loss, one_loss, rtol=DP_RTOL, atol=0)
    out.update(dp_loss=float(dp_loss), single_loss=float(one_loss), dp_max_abs_diff=worst)
    return out


def _sequence_body(sharding, dev, wakewords, config, frames: np.ndarray) -> dict:
    """frames (T, B, n) through a sharded BatchedDetector of global B, this
    rank's block each chunk; every Event field gathered over the ranks, as
    numpy (T, B, ...), and the fleet count of each chunk (T,)."""
    det = BatchedDetector(wakewords, config, batch_size=frames.shape[1], device=dev,
                          sharding=sharding)
    x = sharding.local(torch.tensor(frames, device=dev), axis=1)
    states = det.init_states()
    chunks, counts = [], []
    for t in range(x.shape[0]):
        states, ev = det.process_chunk(det.params, states, x[t])
        counts.append(int(fleet_detection_count(sharding, ev.fired)))
        row = {}
        for f in ev._fields[1:]:
            row["fired"], row[f] = gather_detections(sharding, ev.fired, getattr(ev, f))
        chunks.append({k: v.cpu().numpy() for k, v in row.items()})
    out = {f: np.stack([c[f] for c in chunks]) for f in ev._fields}
    out["fleet_count"] = np.array(counts)
    return out


def _collectives_body(sharding, dev, fired: np.ndarray, payload: np.ndarray) -> dict:
    """This rank's block of the global (fired, payload), then the fleet
    count and the gathered pair, as numpy."""
    f = sharding.local(torch.tensor(fired, device=dev))
    p = sharding.local(torch.tensor(payload, device=dev))
    count = fleet_detection_count(sharding, f)
    g_fired, g_payload = gather_detections(sharding, f, p)
    return {"count": int(count), "fired": g_fired.cpu().numpy(),
            "payload": g_payload.cpu().numpy(), "local": int(f.numel())}


def _rank_entry(rank: int, world: int, device_type: str, tmp: str, body, args) -> None:
    """One spawned rank: join the group (gloo on the CPU, NCCL on card
    `rank`), run body(sharding, device, *args), and pickle its result."""
    torch.set_num_threads(1)
    device = "cpu" if device_type == "cpu" else f"cuda:{rank}"
    dev = multihost_initialize(f"file://{os.path.join(tmp, 'rendezvous')}", world, rank,
                               device=device)
    try:
        out = body(make_stream_group(), dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(body, n: int, device_type: str, args=(), timeout_s: float = 600.0,
                workdir: Optional[str] = None) -> list:
    """Spawn `n` ranks (device_type "cpu": gloo; "cuda": NCCL, one card per
    rank), run body(sharding, device, *args) in each, and return the
    ranks' results in rank order. `body` is a function of this module.
    Raises if a rank fails, or after `timeout_s`, when every rank is
    stopped. The rendezvous file lives in a fresh temporary directory,
    made inside `workdir` when one is given."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got {device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} CUDA cards, found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = mp.start_processes(_rank_entry, args=(n, device_type, tmp, body, args),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{n} ranks did not end in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        out = []
        for r in range(n):
            # written by the ranks just spawned
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def dryrun_multigpu(n: int, device_type: str = "cuda", **kw) -> List[dict]:
    """The dry run (see the module docstring) over `n` ranks: each rank's
    summary. `kw` as for `spawn_ranks`."""
    return spawn_ranks(_dryrun_body, n, device_type, **kw)


def sharded_sequence(n: int, device_type: str, wakewords, config, frames: np.ndarray,
                     **kw) -> List[dict]:
    """frames (T, B, n) through a BatchedDetector sharded over `n` ranks:
    per rank, the gathered events {field: (T, B, ...)} and "fleet_count"."""
    return spawn_ranks(_sequence_body, n, device_type, (wakewords, config, frames), **kw)


def gather_blocks(n: int, device_type: str, fired: np.ndarray, payload: np.ndarray,
                  **kw) -> List[dict]:
    """Each of `n` ranks takes its block of the global (fired, payload) and
    returns the fleet count and the gathered pair."""
    return spawn_ranks(_collectives_body, n, device_type, (fired, payload), **kw)


if __name__ == "__main__":
    n_ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for row in dryrun_multigpu(n_ranks, sys.argv[2] if len(sys.argv) > 2 else "cuda"):
        print(json.dumps(row))
