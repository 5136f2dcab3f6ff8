"""Batched streaming runtime: N concurrent audio streams on one device.

The counterpart of `rustpotter_tpu.runtime.batch.BatchedDetector`: one call
advances every stream 30 ms; wakeword templates and NN weights are shared by
all streams. Stream lifecycle is mask-based: `reset_streams` clears any
subset of streams (admit/retire).

Runtime management (parity: the reference's src/detector.rs:257-346):
  - `add_wakeword` / `remove_wakeword` rebuild the bundle and MIGRATE live
    stream state — the reference keeps its MFCC window, filters and partial
    detections across a wakeword change. Window and gain shapes that grow or
    shrink with max_mfcc_frames are padded or truncated keeping the newest
    entries; a partial detection pointing at a removed wakeword is dropped.
  - `update_detector_config` resets stream state (window, extractor, VAD,
    partial) but KEEPS filter state — the reference's update_detector_config
    calls reset(), which does not touch the filters (detector.rs:263-287).
  - `update_filters_config` additionally rebuilds the filters with fresh
    state (detector.rs:283-287): fresh biquad taps and gain window.
A rebuild that raises leaves the detector as it was. The resampler's
overlap (`in_graph_resample`) survives every migration, as the reference's
encoder is not part of its reset.

Sharding (`sharding=`, a `parallel.mesh.StreamSharding`; the counterpart
of the JAX runtime's `shard_map` path): one process per card, `batch_size`
the global B, and each rank holds its contiguous block of B / world streams
(`local_batch`; ValueError when B does not divide). The parameters are built
on every rank (replicated; the bundle build is deterministic). Every call
that takes or gives states, frames, events or a reset mask takes or gives
the rank's block: slice a global tensor with `StreamSharding.local`. Each
rank keeps its own cursor; the cursors advance in step, since every rank
runs every chunk. The chunk itself needs no collective; detections merge
through `parallel.collectives`. The management calls run on each rank on
its own block.

On the card the chunk runs as a CUDA graph (`runtime.graph.GraphedStep`),
the counterpart of the JAX runtime's `jax.jit(chunk_fn, donate_argnums=(1,))`:
`process_chunk` copies the frames into the graph's input buffer, replays it
and clones the Event's fields (eight device copies outside the graph), and
`process_sequence` replays it T times (per chunk one input copy and seven
field copies, nothing read on the host), the counterpart of the jitted
`lax.scan`. A new state set or parameter set is captured at its first chunk,
which runs eagerly; a rebuild (`add_wakeword`, `remove_wakeword`,
`update_*config`) makes a new `GraphedStep`, and the old graph goes with the
old one. `reset_streams` is a graph too, the counterpart of the JAX
runtime's `jax.jit(_reset_streams)`: a `GraphedStep` of `make_reset(static)`
keyed as the chunk's (the parameter set, the states' addresses, the mask's
shape), captured at its key's first call after an eager call; each later
call copies the mask into the graph's (B,) input and replays it. It writes
the fresh values into the masked streams in place, so the chunk's graph
stays valid and is not captured again; a rebuild drops it with the chunk's.
On the CPU the chunk and the reset run eagerly. The eager functions are
`make_batched_chunk(static)` and `make_reset(static, device)`.

Differences from the JAX runtime: `process_chunk` updates the states in place
(the counterpart of donating them) and still returns them. What runs on the
host between replays: the frames' conversion (`torch.as_tensor`), the
capture key, and the management calls; migration is a host-side step outside
the chunk that reads the shared cursor once.

Spans on the host path (`utils/tracing.py`; recorded with tracing on, and
in any torch.profiler profile): `rustpotter.process_chunk` or
`rustpotter.process_sequence` is the root of a call's spans, with the
chunk id of its first chunk (the detector's count of chunks handed over,
kept across rebuilds); inside it `rustpotter.feed` (the frames' conversion,
a synchronous copy to the card) and the chunk's `GraphedStep` spans
(`rustpotter.graph` and its children, `runtime/graph.py`), a sequence's
per-chunk spans with their own chunk's id. `rustpotter.bundle` is the
bundle build of `_install`, at set-up and at every rebuild (a root span, no
chunk id). Whether tracing is on is part of the capture key: toggling it
captures the chunk again at the next call.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, FiltersConfig, RustpotterConfig
from ..device import DeviceLike, resolve_device
from ..parallel.mesh import StreamSharding
from ..utils import tracing
from ..wakewords.files import load_wakeword
from .bundle import StepParams, StepStatic, Wakeword, build_bundle
from .graph import GraphedStep
from .state import Event, StreamState, init_state
from .stream_step import make_batched_chunk

# Fields `reset_streams` leaves alone: rot — the cursor is shared by all
# streams; win — window content is left stale on purpose: win_count=0 masks
# scoring until the window refills.
_RESET_SKIP_FIELDS = frozenset({"rot", "win"})


def make_reset(static: StepStatic, device: torch.device):
    """reset(params, states, mask (B,) bool) -> (states, ()): every field but
    `_RESET_SKIP_FIELDS` takes its fresh value in the streams where mask is
    True, in place (the `GraphedStep` form; params is not read). The fresh
    values are one stream's `init_state`, made once here and broadcast over
    the streams: one `where` per field, written over the field."""
    fresh = [(f, v) for f, v in zip(StreamState._fields, init_state(static, 1, device))
             if f not in _RESET_SKIP_FIELDS]

    def reset(params, states: StreamState, mask: torch.Tensor):
        for f, row in fresh:
            a = getattr(states, f)
            torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), row, a, out=a)
        return states, ()

    return reset


def _keep_newest(arr: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Resize a shift-register axis (newest entries at the END): truncate the
    oldest entries or zero-pad in front."""
    old_len = arr.shape[axis]
    if new_len <= old_len:
        return arr.narrow(axis, old_len - new_len, new_len)
    shape = list(arr.shape)
    shape[axis] = new_len - old_len
    return torch.cat([arr.new_zeros(shape), arr], dim=axis)


def _pad_tail(arr: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Resize a payload axis (entries at the FRONT): truncate or zero-pad."""
    old_len = arr.shape[axis]
    if new_len <= old_len:
        return arr.narrow(axis, 0, new_len)
    shape = list(arr.shape)
    shape[axis] = new_len - old_len
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def migrate_states(
    old: StepStatic,
    new: StepStatic,
    states: StreamState,
    batch_size: int,
    reset_stream: bool = False,
    reset_filters: bool = False,
) -> StreamState:
    """Carry live stream state across a bundle rebuild (see the module
    docstring), in the serving layout: window (F, C, B), one shared cursor.
    Returns fresh tensors on the states' device."""
    dev = states.win.device
    fresh = init_state(new, batch_size, dev)
    if reset_stream:
        out = fresh
        if not reset_filters:
            out = out._replace(
                bp=states.bp.clone(),
                gain_win=_keep_newest(states.gain_win, -1, new.gain_window_size).clone(),
                gain_count=torch.clamp(states.gain_count, max=new.gain_window_size),
                gain=states.gain.clone(),
            )
        # the encoder/resampler is not part of reset() (detector.rs:290-302)
        return out._replace(rs_overlap=states.rs_overlap.clone(),
                            rms_level=states.rms_level.clone())

    # wakeword add/remove: carry everything, resizing shape-bearing fields
    remap = np.full((max(len(old.names), 1),), -1, np.int32)
    for i, n in enumerate(old.names):
        if n in new.names:
            remap[i] = new.names.index(n)
    new_ww = torch.tensor(remap, device=dev)[states.partial_ww.long()]
    keep = ~(states.partial_active & (new_ww < 0))
    # linearize the circular window (newest frame last) before resizing; the
    # migrated state restarts with a fresh cursor
    win_lin = torch.roll(states.win, -(int(states.rot) + 1), dims=0)
    F = new.max_mfcc_frames
    return states._replace(
        win=_keep_newest(win_lin, 0, F).contiguous(),
        rot=torch.tensor(F - 1, dtype=torch.int32, device=dev),
        win_count=torch.clamp(states.win_count, max=F),
        gain_win=_keep_newest(states.gain_win, -1, new.gain_window_size).clone(),
        gain_count=torch.clamp(states.gain_count, max=new.gain_window_size),
        partial_scores=_pad_tail(states.partial_scores, -1, new.smax).clone(),
        partial_ww=torch.where(keep, torch.clamp(new_ww, min=0), 0).to(torch.int32),
        partial_active=states.partial_active & keep,
        partial_counter=torch.where(keep, states.partial_counter, 0).to(torch.int32),
        countdown=torch.where(keep, states.countdown, 0).to(torch.int32),
    )


class BatchedDetector:
    """Fixed-capacity batch of independent detector streams on `device`
    (default: the CUDA card; RuntimeError without one); with `sharding`,
    this rank's block of them (see the module docstring)."""

    def __init__(
        self,
        wakewords: List[Tuple[str, Wakeword]],
        config: Optional[RustpotterConfig] = None,
        batch_size: int = 1024,
        device: DeviceLike = None,
        in_graph_resample: bool = False,
        sharding: Optional[StreamSharding] = None,
    ):
        self.device = resolve_device(device)
        self.config = config if config is not None else RustpotterConfig()
        self.batch_size = batch_size
        self.sharding = sharding
        # the streams this process holds: all B, or this rank's block
        self.local_batch = sharding.local_size(batch_size) if sharding else batch_size
        self._in_graph_resample = in_graph_resample
        self._handed = 0  # chunks handed over: the tracer's chunk ids
        self._install(list(wakewords), self.config)

    # ------------------------------------------------------------- build

    def _install(self, wakewords: List[Tuple[str, Wakeword]],
                 config: RustpotterConfig) -> None:
        """Build the bundle and the chunk for `wakewords` under `config`,
        and only then adopt them: a build that raises changes nothing."""
        with tracing.span("rustpotter.bundle"):
            static, params = build_bundle(wakewords, config, self.device,
                                          self._in_graph_resample)
        chunk = GraphedStep(make_batched_chunk(static))
        reset = GraphedStep(make_reset(static, self.device))
        self._wakewords, self.config = wakewords, config
        self.static, self.params, self._chunk, self._reset = static, params, chunk, reset

    def _rebuild(self, wakewords, config, states, reset_stream=False,
                 reset_filters=False) -> Optional[StreamState]:
        old_static = self.static
        self._install(wakewords, config)
        if states is None:
            return None
        return migrate_states(old_static, self.static, states, self.local_batch,
                              reset_stream=reset_stream, reset_filters=reset_filters)

    # --------------------------------------------------- wakeword management

    @property
    def wakeword_names(self) -> Tuple[str, ...]:
        return self.static.names

    def add_wakeword(self, name: str, wakeword: Wakeword,
                     states: Optional[StreamState] = None) -> Optional[StreamState]:
        """Add (or replace) a wakeword on the live detector. Stream state is
        carried over (detector.rs:304-346: no reset on add); pass the current
        states to receive the migrated ones. Raises ValueError on an
        mfcc_size mismatch, leaving the detector unchanged."""
        ww = [(k, w) for k, w in self._wakewords if k != name] + [(name, wakeword)]
        return self._rebuild(ww, self.config, states)

    def add_wakeword_from_file(self, name: str, path: str,
                               states: Optional[StreamState] = None) -> Optional[StreamState]:
        return self.add_wakeword(name, load_wakeword(path), states)

    def remove_wakeword(self, name: str,
                        states: Optional[StreamState] = None) -> Optional[StreamState]:
        """Remove a wakeword; stream state carries over, except partials that
        pointed at the removed wakeword (dropped). Raises KeyError if absent,
        ValueError when removing the last wakeword (the batched step has no
        empty configuration — retire the detector instead)."""
        if name not in dict(self._wakewords):
            raise KeyError(name)
        ww = [(k, w) for k, w in self._wakewords if k != name]
        if not ww:
            raise ValueError("cannot remove the last wakeword of a BatchedDetector")
        return self._rebuild(ww, self.config, states)

    # ------------------------------------------------------- config updates

    def update_detector_config(self, det_config: DetectorConfig,
                               states: Optional[StreamState] = None) -> Optional[StreamState]:
        """Reference parity (detector.rs:263-280): score params propagate to
        live detectors and stream state resets — filters keep their state."""
        config = copy.copy(self.config)
        config.detector = det_config
        return self._rebuild(self._wakewords, config, states, reset_stream=True)

    def update_filters_config(self, filters_config: FiltersConfig,
                              states: Optional[StreamState] = None) -> Optional[StreamState]:
        """Reference parity (detector.rs:283-287): filters rebuilt with fresh
        state, stream state resets."""
        config = copy.copy(self.config)
        config.filters = filters_config
        return self._rebuild(self._wakewords, config, states, reset_stream=True,
                             reset_filters=True)

    def update_config(self, config: RustpotterConfig,
                      states: Optional[StreamState] = None) -> Optional[StreamState]:
        return self._rebuild(self._wakewords, config, states, reset_stream=True,
                             reset_filters=True)

    # ------------------------------------------------------------ lifecycle

    def init_states(self) -> StreamState:
        return init_state(self.static, self.local_batch, self.device)

    def _frames(self, frames) -> torch.Tensor:
        with tracing.span("rustpotter.feed"):
            x = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        n = self.static.input_samples
        if x.shape[-2:] != (self.local_batch, n):
            raise ValueError(
                f"frames must end in ({self.local_batch}, {n}), got {tuple(x.shape)}"
            )
        return x

    def process_chunk(self, params: StepParams, states: StreamState,
                      frames) -> Tuple[StreamState, Event]:
        """Advance every stream by one 30 ms chunk, frames (B, input_samples)
        with B the local batch: 480 samples at 16 kHz, or
        `static.input_samples` raw samples at the input rate with
        `in_graph_resample` (1440 at 48 kHz). `states` is updated in place
        and returned with the Event (B,)."""
        with tracing.span("rustpotter.process_chunk", chunk=self._handed):
            x = self._frames(frames)
            self._handed += 1
            return self._chunk(params, states, x)

    def process_sequence(self, params: StepParams, states: StreamState,
                         frames) -> Tuple[StreamState, Event]:
        """frames (T, B, input_samples): T chunks in order. Returns the
        states and the Events stacked on a leading (T,) axis."""
        with tracing.span("rustpotter.process_sequence", chunk=self._handed):
            xs = self._frames(frames)
            self._handed += xs.shape[0]
            return self._chunk.sequence(params, states, xs)

    def reset_streams(self, states: StreamState, mask) -> StreamState:
        """Clear streams where mask (B,) is True, in place (so the chunk's
        graph stays valid); on the card by a graph's replay (see the module
        docstring). Sharded, the mask is this rank's block
        (`StreamSharding.local` of a global mask)."""
        m = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        return self._reset(self.params, states, m)[0]


def events_to_numpy(ev: Event) -> Event:
    """An Event of numpy arrays (host copy)."""
    return Event(*[np.asarray(x.cpu()) for x in ev])
