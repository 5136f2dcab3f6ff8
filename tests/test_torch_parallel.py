"""Stream sharding of the PyTorch port over torch.distributed (gloo ranks on
the CPU, spawned from `rustpotter_tpu_torch.parallel.dryrun`, a module
without JAX) against the port's unsharded detector and the JAX package's
sharded detector on a 2-device virtual mesh.

  - 2 ranks of 4 streams through the 30-frame bench wakeword's correctness
    stream on streams 1 and 6 (one on each rank): the events gathered over
    the ranks equal the port's unsharded B = 8 run (events equal, scores
    rtol 1e-6, as `tests/test_batch_parallel.py` holds JAX's sharded run)
    and JAX's sharded BatchedDetector (events equal, scores rtol and atol
    2e-5);
  - gather_detections and fleet_detection_count at 4 ranks, as
    `tests/test_batch_parallel.py::test_collectives_merge`;
  - the dry run at 2 ranks: one sharded chunk, and a data-parallel SGD step
    equal to the single-process step (rtol 1e-6);
  - a B that does not divide over the ranks raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.parallel.mesh import StreamSharding as JaxStreamSharding
from rustpotter_tpu.parallel.mesh import make_stream_mesh
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.parallel import dryrun
from rustpotter_tpu_torch.parallel.mesh import (
    StreamSharding,
    make_stream_group,
    multihost_initialize,
)
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

torch.set_num_threads(2)

B, RANKS = 8, 2
PLAYING = (1, 6)  # stream 1 on rank 0, stream 6 on rank 1
JAX_TOL = dict(rtol=2e-5, atol=2e-5)
EVENT_FIELDS = ("fired", "ww", "score", "avg_score", "counter", "gain", "scores")


def _configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    return jcfg, cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(frames, the port's wakeword list, the JAX one, the gathered events
    of the 2-rank run per rank)."""
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    jww = JaxWakewordRef(name=ww.name, samples_features=dict(ww.samples_features),
                         avg_features=ww.avg_features, rms_level=ww.rms_level)
    stream = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(3).normal(0, 0.05, (len(stream), B, 480)).astype(np.float32)
    for b in PLAYING:
        frames[:, b] = stream
    gathered = dryrun.sharded_sequence(RANKS, "cpu", [("w", ww)], _configs()[1], frames,
                                       timeout_s=300,
                                       workdir=str(tmp_path_factory.mktemp("ranks")))
    return frames, [("w", ww)], [("w", jww)], gathered


def test_sharded_detector_equals_unsharded(run):
    frames, wws, _, gathered = run
    det = BatchedDetector(wws, _configs()[1], batch_size=B, device="cpu")
    states, ev = det.process_sequence(det.params, det.init_states(), frames)
    want = events_to_numpy(ev)._asdict()
    fired = want["fired"]
    assert [int(fired[:, b].sum()) for b in range(B)] == [int(b in PLAYING) for b in range(B)]
    for rank, got in enumerate(gathered):
        for f in ("fired", "ww", "counter"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"rank {rank} {f}")
        for f in ("score", "avg_score", "scores", "gain"):
            np.testing.assert_allclose(got[f][fired], want[f][fired], rtol=1e-6,
                                       err_msg=f"rank {rank} {f}")
        np.testing.assert_array_equal(got["fleet_count"], fired.sum(axis=1))


def test_sharded_detector_equals_jax_sharded_mesh(run):
    frames, _, jwws, gathered = run
    sharding = JaxStreamSharding(make_stream_mesh(jax.devices()[:RANKS]))
    jdet = JaxBatchedDetector(jwws, _configs()[0], batch_size=B, sharding=sharding)
    _, jev = jdet.process_sequence(
        jdet.params, jdet.init_states(),
        jax.device_put(jnp.asarray(frames), sharding.time_batched),
    )
    want = {f: np.asarray(getattr(jev, f)) for f in EVENT_FIELDS}
    fired = want["fired"]
    assert fired.sum() == len(PLAYING)
    got = gathered[0]
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("score", "avg_score", "scores", "gain"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **JAX_TOL, err_msg=f)


def test_collectives_merge(tmp_path):
    """tests/test_batch_parallel.py::test_collectives_merge over 4 gloo ranks."""
    fired = np.zeros(16, bool)
    fired[[5, 12]] = True
    payload = np.arange(16, dtype=np.float32)
    out = dryrun.gather_blocks(4, "cpu", fired, payload, timeout_s=300, workdir=str(tmp_path))
    assert len(out) == 4
    for r in out:
        assert r["local"] == 4
        assert r["count"] == 2
        assert r["fired"].sum() == 2
        np.testing.assert_array_equal(r["fired"], fired)
        np.testing.assert_array_equal(r["payload"], payload)


def test_dryrun_multigpu_on_gloo(tmp_path):
    out = dryrun.dryrun_multigpu(RANKS, "cpu", timeout_s=300, workdir=str(tmp_path))
    assert [r["rank"] for r in out] == list(range(RANKS))
    for r in out:
        assert r["world"] == RANKS and r["local_batch"] == dryrun.STREAMS_PER_RANK
        assert r["gathered"] == dryrun.STREAMS_PER_RANK * RANKS
        assert r["fleet_count"] == out[0]["fleet_count"]
        np.testing.assert_allclose(r["dp_loss"], r["single_loss"], rtol=1e-6, atol=0)
        assert r["dp_max_abs_diff"] <= 1e-6


def test_uneven_batch_raises():
    sharding = StreamSharding(group=None, rank=0, world=3)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_size(B)
    ww, _ = build_bench_wakeword(device="cpu", longest=30)
    with pytest.raises(ValueError, match="does not divide"):
        BatchedDetector([("w", ww)], RustpotterConfig(), batch_size=B, device="cpu",
                        sharding=sharding)


def test_local_block_and_rendezvous_checks():
    sharding = StreamSharding(group=None, rank=1, world=2)
    assert sharding.local_slice(B) == slice(4, 8)
    x = torch.arange(2 * B).reshape(2, B)
    assert torch.equal(sharding.local(x, axis=1), x[:, 4:])
    assert torch.equal(sharding.local(torch.arange(B)), torch.arange(4, 8))
    with pytest.raises(RuntimeError, match="not initialized"):
        make_stream_group()
    with pytest.raises(ValueError, match="init_method"):
        multihost_initialize("tcp://10.0.0.1:29500", 2, 0, device="cpu")


def test_rank_block_with_management_equals_the_unsharded_block(run):
    """Rank 1 of 2 (no process group is needed for the chunk) gives the
    unsharded detector's streams 4-7 chunk by chunk, across a live
    add_wakeword with its state migration and a reset of a global mask
    taken through StreamSharding.local."""
    frames, wws, _, _ = run
    sharding = StreamSharding(group=None, rank=1, world=RANKS)
    _, nn = dryrun.synthetic_wakewords(n_templates=3, frames=24, mfcc_size=16, train_size=16)
    full = BatchedDetector(wws, _configs()[1], batch_size=B, device="cpu")
    block = BatchedDetector(wws, _configs()[1], batch_size=B, device="cpu", sharding=sharding)
    assert block.local_batch == B // RANKS
    s_full, s_block = full.init_states(), block.init_states()
    mask = torch.zeros(B, dtype=torch.bool)
    mask[[2, 7]] = True
    x = torch.tensor(frames)
    fires = 0
    for t in range(x.shape[0]):
        if t == 10:
            s_full, s_block = full.add_wakeword(*nn, s_full), block.add_wakeword(*nn, s_block)
        if t == 20:
            s_full = full.reset_streams(s_full, mask)
            s_block = block.reset_streams(s_block, sharding.local(mask))
        s_full, ev_full = full.process_chunk(full.params, s_full, x[t])
        s_block, ev_block = block.process_chunk(block.params, s_block, sharding.local(x[t]))
        want = {f: sharding.local(getattr(ev_full, f)) for f in EVENT_FIELDS}
        fires += int(ev_block.fired[PLAYING[1] - B // RANKS])
        for f in ("fired", "ww", "counter"):
            assert torch.equal(getattr(ev_block, f), want[f]), (t, f)
        for f in ("score", "avg_score", "scores"):
            torch.testing.assert_close(getattr(ev_block, f), want[f], rtol=1e-6, atol=0,
                                       equal_nan=True)
    assert fires == 1  # stream 6 detects the utterance on its rank
    assert int(s_block.rot) == int(s_full.rot)
    assert block.wakeword_names == full.wakeword_names == ("w", nn[0])
