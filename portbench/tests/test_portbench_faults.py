"""A run whose timed path is broken underneath comes out not correct.

The run is driven on the CPU past the harness's look for a card
(`harness.run(device="cpu")`), with `BatchedDetector` replaced by a
subclass that breaks what it returns, once for each fault a one-chip cell
of this benchmark can have: a step that returns its state unchanged; half
of the fleet left out; an answer altered where it is produced. (No cell
exchanges anything between cards.)"""
import pytest
import torch

import rustpotter_tpu_torch as rp
from portbench import harness

TRAFFIC = {"streams": 8, "utterance_every": 4, "check_streams": 6, "check_utterance": 2,
        "check_near": 2, "profile_steps": 1}
STEPS = {"backlog": 5, "serve": 200}


def _clone(states):
    return type(states)(*[t.clone() for t in states])


class StateUnchanged(rp.BatchedDetector):
    """Computes the chunk on a copy and hands back the states it was given."""

    def process_chunk(self, params, states, frames):
        return states, super().process_chunk(params, _clone(states), frames)[1]

    def process_sequence(self, params, states, frames):
        return states, super().process_sequence(params, _clone(states), frames)[1]


class HalfFleet(rp.BatchedDetector):
    """Advances only the first half of the streams; the second half keeps
    its state and reports nothing."""

    def _half(self, states, call):
        keep = _clone(states)
        states, ev = call(states)
        h = self.local_batch // 2
        for old, new in zip(keep, states):
            if new.dim() and new.shape[-1] == self.local_batch and new.dim() == 3:
                new[..., h:] = old[..., h:]
            elif new.dim() and new.shape[0] == self.local_batch:
                new[h:] = old[h:]
        ev.fired[..., h:] = False
        return states, ev

    def process_chunk(self, params, states, frames):
        return self._half(states, lambda s: super(HalfFleet, self).process_chunk(params, s, frames))

    def process_sequence(self, params, states, frames):
        return self._half(states, lambda s: super(HalfFleet, self).process_sequence(params, s, frames))


class AlteredAnswer(rp.BatchedDetector):
    """Reports every detection's score 0.01 too high."""

    def process_chunk(self, params, states, frames):
        states, ev = super().process_chunk(params, states, frames)
        return states, ev._replace(score=ev.score + 0.01 * ev.fired)

    def process_sequence(self, params, states, frames):
        states, ev = super().process_sequence(params, states, frames)
        return states, ev._replace(score=ev.score + 0.01 * ev.fired)


@pytest.mark.parametrize("cell", ["dtw_bench.backlog", "nn_medium.serve"])
@pytest.mark.parametrize("fault", [StateUnchanged, HalfFleet, AlteredAnswer])
def test_a_broken_step_is_not_correct(cell, fault):
    traffic = dict(TRAFFIC, warmup_steps=STEPS[cell.split(".")[1]])
    res = harness.run(cell, 99, 0.01, False, 0.0, device="cpu", traffic=traffic,
                      detector_cls=fault)
    assert res["checks"]["reference_fires"]["value"] >= 1
    assert not res["correct"], res["checks"]
