"""Process groups for the stream-parallel runtime.

The counterpart of `rustpotter_tpu.parallel.mesh`. The workload is
data-parallel over audio streams: templates and NN weights are a few MB and
are replicated on every card; only the stream axis is split. JAX runs one
process over a 1-D mesh of devices; this port runs one process per card in
a `torch.distributed` process group, and each rank holds a contiguous block
of the global stream axis (rank r of W holds streams r·B/W ... (r+1)·B/W - 1).

`multihost_initialize` joins the group (NCCL for CUDA tensors, gloo for CPU
tensors) through a rendezvous on this host (`file://` or
`tcp://127.0.0.1`); `make_stream_group` describes the rank's block. A
failed initialization raises; nothing falls back to another backend.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

STREAMS_AXIS = "streams"


@dataclass(frozen=True)
class StreamSharding:
    """This rank's place on the stream axis: its process group (None is the
    default group), its rank and the world size."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int

    def local_size(self, batch_size: int) -> int:
        """Streams per rank; ValueError when `batch_size` does not divide
        evenly over the ranks."""
        if batch_size % self.world:
            raise ValueError(
                f"batch_size {batch_size} does not divide over {self.world} ranks"
            )
        return batch_size // self.world

    def local_slice(self, batch_size: int) -> slice:
        """This rank's block of a global stream axis of `batch_size`."""
        n = self.local_size(batch_size)
        return slice(self.rank * n, (self.rank + 1) * n)

    def local(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of a global tensor along `axis` (a view): the
        frames (B, ...) or a reset mask (B,), or (T, B, ...) with axis=1."""
        sl = self.local_slice(x.shape[axis])
        return x.narrow(axis, sl.start, sl.stop - sl.start)


def rank_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the card of this rank on its host: cuda:{LOCAL_RANK}
    (LOCAL_RANK from the environment, 0 without it)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return resolve_device(device)


def multihost_initialize(init_method: str, world_size: int, rank: int,
                         device: DeviceLike = None, **kwargs) -> torch.device:
    """Join the process group (torch.distributed.init_process_group) and
    return this rank's device. The backend follows the device: NCCL on a
    card (the rank's card becomes the current one and the communicator is
    set up at once, so a failure raises here), gloo on the CPU.
    `init_method` is a rendezvous on this host: "file://<path>" (the file
    must not exist yet) or "tcp://127.0.0.1:<port>"."""
    if not init_method.startswith(("file://", "tcp://127.0.0.1:", "tcp://localhost:")):
        raise ValueError(
            f"init_method must be file:// or tcp://127.0.0.1:<port>, got {init_method!r}"
        )
    dev = rank_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size,
                                rank=rank, device_id=dev, **kwargs)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size,
                                rank=rank, **kwargs)
    return dev


def make_stream_group(group: Optional[dist.ProcessGroup] = None) -> StreamSharding:
    """The counterpart of `make_stream_mesh`: this rank's StreamSharding in
    `group` (default: the whole world). RuntimeError before
    `multihost_initialize`."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call multihost_initialize")
    return StreamSharding(group=group, rank=dist.get_rank(group),
                          world=dist.get_world_size(group))
