"""Rustpotter: the single-stream host API around the per-shift stream step.

The counterpart of `rustpotter_tpu.runtime.detector`, with public-API parity
with the reference's src/detector.rs (Rustpotter struct): new /
add_wakeword* / remove_wakeword(s) / process_bytes / process_samples /
update_config / reset / getters, and RustpotterDetection
(detector.rs:486-501), for DTW and NN wakewords, with the gain normalizer
and band-pass filters, at any input rate.

The audio encoder (byte decode, downmix, resampling another rate to 16 kHz
through the host `FftResampler`) runs on the host as the reference's; everything from the 480-sample f32 frame onward is
`stream_step.make_step` at B = 1, with params and state on `device` (default:
the CUDA card).

On the card the step runs as a CUDA graph (`runtime.graph.GraphedStep`), the
counterpart of the JAX package's `jax.jit(step)`: `process_audio` copies the
frame into the graph's input buffer, replays it and clones the Event's
fields. The frame loop stays on the host, as in JAX: the encoder, the read
of `fired` after every frame, the decode of a detection, and with
`record_path` the reads of the partial detection around the step. `process_audio_sequence`
replays the graph once per frame and reads the events back once, at the
end, as JAX's `_scan` does. `reset()` writes the fresh state into the
state's tensors, so the graph stays valid; a wakeword or config change
rebuilds the step and captures again at its first frame, which runs
eagerly. On the CPU the step runs eagerly. The eager step is
`make_step(static)`.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..audio.encoder import AudioEncoder
from ..config import RustpotterConfig
from ..constants import DETECTOR_INTERNAL_SAMPLE_RATE, SAMPLES_PER_FRAME
from ..device import DeviceLike, resolve_device
from ..utils.wav import write_wav
from ..wakewords.files import WakewordModel, WakewordRef, load_wakeword
from .bundle import StepParams, StepStatic, build_bundle
from .graph import GraphedStep
from .state import Event, StreamState, init_state
from .stream_step import make_step


@dataclass
class RustpotterDetection:
    """Detection payload (parity: detector.rs:486-501)."""

    name: str
    avg_score: float
    score: float
    scores: Dict[str, float]
    counter: int
    gain: float


class Rustpotter:
    """Streaming wakeword spotter over one audio stream on `device` (default:
    the CUDA card; RuntimeError without one)."""

    def __init__(self, config: Optional[RustpotterConfig] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config if config is not None else RustpotterConfig()
        self.wav_encoder = AudioEncoder(self.config.fmt)
        self.wakewords: List[tuple] = []  # (key, wakeword) insertion-ordered
        self._static: Optional[StepStatic] = None
        self._params: Optional[StepParams] = None
        self._step = None
        self._state: Optional[StreamState] = None
        self._audio_window = np.zeros(0, np.float32)

    # ---------------------------------------------------------- wakewords
    def add_wakeword_from_file(self, key: str, path: str) -> None:
        self.add_wakeword(key, load_wakeword(path))

    def add_wakeword_from_buffer(self, key: str, buffer: bytes) -> None:
        self.add_wakeword(key, load_wakeword(buffer))

    def add_wakeword_ref(self, key: str, wakeword: WakewordRef) -> None:
        self.add_wakeword(key, wakeword)

    def add_wakeword_model(self, key: str, wakeword: WakewordModel) -> None:
        self.add_wakeword(key, wakeword)

    def add_wakeword(self, key: str, wakeword: Union[WakewordRef, WakewordModel]) -> None:
        prev = list(self.wakewords)
        self.wakewords = [(k, w) for k, w in self.wakewords if k != key]
        self.wakewords.append((key, wakeword))
        try:
            self._rebuild()
        except ValueError:
            # e.g. mismatched mfcc size (detector.rs:308-320): keep the
            # prior set
            self.wakewords = prev
            self._rebuild()
            raise

    def remove_wakeword(self, key: str) -> bool:
        n = len(self.wakewords)
        self.wakewords = [(k, w) for k, w in self.wakewords if k != key]
        if len(self.wakewords) != n:
            self._rebuild()
            return True
        return False

    def remove_wakewords(self) -> bool:
        if self.wakewords:
            self.wakewords = []
            self._rebuild()
            return True
        return False

    def _rebuild(self) -> None:
        if not self.wakewords:
            self._static = self._params = self._step = self._state = None
            return
        self._static, self._params = build_bundle(self.wakewords, self.config, self.device)
        self._step = GraphedStep(make_step(self._static))
        self._state = init_state(self._static, 1, self.device)

    # ------------------------------------------------------------- config
    def update_config(self, config: RustpotterConfig) -> None:
        self.config = config
        self.wav_encoder = AudioEncoder(config.fmt)
        self._rebuild()
        self.reset()

    def update_detector_config(self, detector_config) -> None:
        self.config.detector = detector_config
        self._rebuild()
        self.reset()

    def update_filters_config(self, filters_config) -> None:
        self.config.filters = filters_config
        self._rebuild()
        self.reset()

    def reset(self) -> None:
        """Clear stream state (detector.rs:290-302), in place (so the step's
        graph stays valid)."""
        if self._static is not None:
            for t, fresh in zip(self._state, init_state(self._static, 1, self.device)):
                t.copy_(fresh)
        self.wav_encoder.reset()

    # ------------------------------------------------------------ getters
    def get_samples_per_frame(self) -> int:
        return self.wav_encoder.get_input_frame_length()

    def get_bytes_per_frame(self) -> int:
        return self.wav_encoder.get_input_byte_length()

    def get_rms_level(self) -> float:
        return float(self._state.rms_level[0]) if self._state is not None else 0.0

    def get_gain(self) -> float:
        return float(self._state.gain[0]) if self._state is not None else 1.0

    def get_rms_level_ref(self) -> float:
        if self._params is None:
            return float("nan")
        return float(np.square(np.float32(self._params.gain_ref_sqrt.item())))

    def get_partial_detection(self) -> Optional[RustpotterDetection]:
        st = self._state
        if st is None or not bool(st.partial_active[0]):
            return None
        return self._decode(int(st.partial_ww[0]), float(st.partial_score[0]),
                            float(st.partial_avg[0]), int(st.partial_counter[0]),
                            float(st.partial_gain[0]), st.partial_scores[0].cpu().numpy())

    # ---------------------------------------------------------- processing
    def process_bytes(self, audio_bytes: bytes) -> Optional[RustpotterDetection]:
        if len(audio_bytes) != self.get_bytes_per_frame() or not self.wakewords:
            return None
        return self.process_audio(self.wav_encoder.encode_and_resample(audio_bytes))

    def process_samples(self, audio_samples) -> Optional[RustpotterDetection]:
        if len(audio_samples) != self.get_samples_per_frame() or not self.wakewords:
            return None
        return self.process_audio(self.wav_encoder.rencode_and_resample(np.asarray(audio_samples)))

    def process_audio(self, samples: np.ndarray) -> Optional[RustpotterDetection]:
        """samples: 480 mono f32 @16 kHz."""
        record_path = self.config.detector.record_path
        st = self._state
        prev_score = float(st.partial_score[0]) if record_path else 0.0
        prev_active = bool(st.partial_active[0]) if record_path else False
        frame = np.asarray(samples, np.float32)
        x = torch.as_tensor(frame, device=self.device).reshape(1, SAMPLES_PER_FRAME)
        self._state, event = self._step(self._params, st, x)
        if record_path:
            self._record_window(frame)
            # a new or improving partial triggers an audio dump
            # (parity: detector.rs:420-423,455-484, `record` cargo feature)
            st = self._state
            if bool(st.partial_active[0]) and (
                not prev_active or float(st.partial_score[0]) > prev_score
            ):
                self._write_record(record_path, float(st.partial_score[0]))
        if bool(event.fired[0]):
            return self._decode_event(event, 0)
        return None

    def _record_window(self, samples: np.ndarray) -> None:
        max_samples = (self._static.max_mfcc_frames // 3) * SAMPLES_PER_FRAME
        buf = np.concatenate([self._audio_window, samples])
        if len(buf) > max_samples:
            buf = buf[len(samples):]
        self._audio_window = buf

    def _write_record(self, record_path: str, score: float) -> None:
        if not os.path.isdir(record_path):
            return
        name = self._static.names[int(self._state.partial_ww[0])]
        ts = int(time.time() * 1000)
        fname = f"[{name}]{ts}-{str(score).replace('.', '_')}.wav"
        write_wav(os.path.join(record_path, fname), self._audio_window,
                  DETECTOR_INTERNAL_SAMPLE_RATE)

    def process_audio_sequence(self, samples: np.ndarray) -> List[RustpotterDetection]:
        """Bulk path: (n*480,) samples, one step per 480-sample frame; the
        events are read back once, at the end."""
        frames = np.asarray(samples, np.float32)
        n = len(frames) // SAMPLES_PER_FRAME
        if n == 0:
            return []
        x = torch.as_tensor(frames[: n * SAMPLES_PER_FRAME], device=self.device)
        self._state, ev = self._step.sequence(self._params, self._state,
                                              x.reshape(n, 1, SAMPLES_PER_FRAME))
        stacked = Event(*[f[:, 0].cpu() for f in ev])  # (n,) per field
        return [self._decode_event(stacked, int(i)) for i in torch.nonzero(stacked.fired)[:, 0]]

    # ------------------------------------------------------------- decode
    def _decode_event(self, event: Event, i: int) -> RustpotterDetection:
        return self._decode(int(event.ww[i]), float(event.score[i]), float(event.avg_score[i]),
                            int(event.counter[i]), float(event.gain[i]),
                            event.scores[i].cpu().numpy())

    def _decode(self, ww, score, avg, counter, gain, scores_vec) -> RustpotterDetection:
        st = self._static
        wakeword = dict(self.wakewords)[st.names[ww]]
        if isinstance(wakeword, WakewordRef):
            labels = st.dtw_template_names[ww]
            name = wakeword.name
        else:
            labels = st.nn_meta[ww - st.n_dtw].labels
            # an NN detection is named by its winning label, which the
            # scores payload (the logits) gives back
            name = labels[int(np.argmax(scores_vec[: len(labels)]))]
        return RustpotterDetection(
            name=name,
            avg_score=avg,
            score=score,
            scores={k: float(scores_vec[i]) for i, k in enumerate(labels)},
            counter=counter,
            gain=gain,
        )
