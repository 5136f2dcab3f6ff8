"""Cross-rank detection merging and fleet metrics.

The counterpart of `rustpotter_tpu.parallel.collectives`: per-rank detection
events merged by all-gather, the fleet's detection count by an all-reduce
(SUM). On the cards the collectives ride NCCL; on the CPU gloo. A tensor
whose device does not match the group's backend raises: no collective runs
on the CPU for a CUDA tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import StreamSharding


def _check_backend(sharding: StreamSharding, x: torch.Tensor) -> None:
    backend = dist.get_backend(sharding.group)
    if (backend == "nccl") != x.is_cuda:
        raise ValueError(
            f"a {x.device.type} tensor in a {backend} group: NCCL takes CUDA "
            "tensors, gloo CPU tensors"
        )


def _all_gather(sharding: StreamSharding, x: torch.Tensor) -> torch.Tensor:
    _check_backend(sharding, x)
    parts = [torch.empty_like(x) for _ in range(sharding.world)]
    dist.all_gather(parts, x.contiguous(), group=sharding.group)
    return torch.cat(parts, dim=0)


def gather_detections(sharding: StreamSharding, fired: torch.Tensor,
                      payload: torch.Tensor):
    """All-gather every rank's block to every rank.

    fired: (B/W,) bool, this rank's streams; payload: (B/W, ...) likewise.
    Returns the global (B,) and (B, ...), in rank order, on every rank."""
    return _all_gather(sharding, fired), _all_gather(sharding, payload)


def fleet_detection_count(sharding: StreamSharding, fired: torch.Tensor) -> torch.Tensor:
    """Total detections across the ranks this chunk: a 0-d int32 tensor on
    fired's device, the same on every rank."""
    _check_backend(sharding, fired)
    count = fired.sum(dtype=torch.int32)
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=sharding.group)
    return count
