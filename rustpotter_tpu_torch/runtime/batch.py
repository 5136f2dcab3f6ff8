"""Batched streaming runtime: N concurrent audio streams on one device.

The counterpart of `rustpotter_tpu.runtime.batch.BatchedDetector`: one call
advances every stream 30 ms; wakeword templates are shared by all streams.
Stream lifecycle is mask-based: `reset_streams` clears any subset of streams
(admit/retire).

Differences from the JAX runtime: `process_chunk` updates the states in place
(the counterpart of donating them) and still returns them; `process_sequence`
is a loop of `process_chunk`. Wakeword add/remove with state migration and
the `update_*config` calls are a later slice (ROADMAP M6).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RustpotterConfig
from ..constants import SAMPLES_PER_FRAME
from ..device import DeviceLike, resolve_device
from ..wakewords.files import WakewordRef
from .bundle import StepParams, build_bundle
from .state import Event, StreamState, init_state
from .stream_step import make_batched_chunk

# Fields `reset_streams` leaves alone: rot — the cursor is shared by all
# streams; win — window content is left stale on purpose: win_count=0 masks
# scoring until the window refills.
_RESET_SKIP_FIELDS = frozenset({"rot", "win"})


class BatchedDetector:
    """Fixed-capacity batch of independent detector streams on `device`
    (default: the CUDA card; RuntimeError without one)."""

    def __init__(
        self,
        wakewords: List[Tuple[str, WakewordRef]],
        config: Optional[RustpotterConfig] = None,
        batch_size: int = 1024,
        device: DeviceLike = None,
        in_graph_resample: bool = False,
    ):
        self.device = resolve_device(device)
        self.config = config if config is not None else RustpotterConfig()
        self.batch_size = batch_size
        self._wakewords = list(wakewords)
        self.static, self.params = build_bundle(
            self._wakewords, self.config, self.device, in_graph_resample
        )
        self._chunk = make_batched_chunk(self.static)

    @property
    def wakeword_names(self) -> Tuple[str, ...]:
        return self.static.names

    def init_states(self) -> StreamState:
        return init_state(self.static, self.batch_size, self.device)

    def _frames(self, frames) -> torch.Tensor:
        x = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        if x.shape[-2:] != (self.batch_size, SAMPLES_PER_FRAME):
            raise ValueError(
                f"frames must end in ({self.batch_size}, {SAMPLES_PER_FRAME}), "
                f"got {tuple(x.shape)}"
            )
        return x

    def process_chunk(self, params: StepParams, states: StreamState,
                      frames) -> Tuple[StreamState, Event]:
        """Advance every stream by one 480-sample chunk, frames (B, 480).
        `states` is updated in place and returned with the Event (B,)."""
        return self._chunk(params, states, self._frames(frames))

    def process_sequence(self, params: StepParams, states: StreamState,
                         frames) -> Tuple[StreamState, Event]:
        """frames (T, B, 480): T chunks in order. Returns the states and the
        Events stacked on a leading (T,) axis."""
        x = self._frames(frames)
        events = []
        for t in range(x.shape[0]):
            states, ev = self._chunk(params, states, x[t])
            events.append(ev)
        return states, Event(*[torch.stack(f) for f in zip(*events)])

    def reset_streams(self, states: StreamState, mask) -> StreamState:
        """Clear streams where mask (B,) is True, in place."""
        m = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        fresh = init_state(self.static, self.batch_size, self.device)
        for f in StreamState._fields:
            if f in _RESET_SKIP_FIELDS:
                continue
            a = getattr(states, f)
            mm = m.reshape(m.shape + (1,) * (a.dim() - 1))
            a.copy_(torch.where(mm, getattr(fresh, f), a))
        return states


def events_to_numpy(ev: Event) -> Event:
    """An Event of numpy arrays (host copy)."""
    return Event(*[np.asarray(x.cpu()) for x in ev])
