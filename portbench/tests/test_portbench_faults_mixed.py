"""The faults of `test_portbench_faults.py` on the cell `mixed.backlog`
(three DTW wakewords and an NN wakeword in one detector), and one more that
only a cell of several wakewords can have: each fired event names another
wakeword. Every one comes out not correct, so the check reads the
reported wakeword (`ww`) where it can differ."""
import pytest

from portbench import harness
from test_portbench_faults import TRAFFIC, AlteredAnswer, HalfFleet, StateUnchanged

import rustpotter_tpu_torch as rp

CELL = "mixed.backlog"


class OtherWakeword(rp.BatchedDetector):
    """Reports every detection as the next wakeword's, in the detector's order."""

    def _other(self, ev):
        n = len(self.wakeword_names)
        return ev._replace(ww=(ev.ww + ev.fired.to(ev.ww.dtype)) % n)

    def process_chunk(self, params, states, frames):
        states, ev = super().process_chunk(params, states, frames)
        return states, self._other(ev)

    def process_sequence(self, params, states, frames):
        states, ev = super().process_sequence(params, states, frames)
        return states, self._other(ev)


@pytest.mark.parametrize("fault", [StateUnchanged, HalfFleet, AlteredAnswer, OtherWakeword])
def test_a_broken_step_of_the_mixed_cell_is_not_correct(fault):
    traffic = dict(TRAFFIC, warmup_steps=5)
    res = harness.run(CELL, 99, 0.01, False, 0.0, device="cpu", traffic=traffic,
                      detector_cls=fault)
    assert res["checks"]["reference_fires"]["value"] >= 1
    assert not res["correct"], res["checks"]
    if fault is OtherWakeword:
        assert res["checks"]["score_gap"]["ok"] and res["checks"]["mfcc_gap"]["ok"]
