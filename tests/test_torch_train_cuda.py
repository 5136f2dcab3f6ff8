"""NN training and the NCCL-sharded detector of the port on a CUDA card,
against the same calls on the CPU. Every test here needs a card (and nvcc,
which builds K1 at first use); without one they skip. The file imports no
JAX:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q

  - training on the card against training on the CPU (the synthetic set at
    42 frames, MEDIUM, 60 epochs): the losses at
    `tests/test_training_torch_crosscheck.py`'s tolerances (the first 10
    epochs rtol 2e-4 / atol 2e-5, all rtol 5e-3 / atol 5e-4), the final
    weights at the late tolerance, the test accuracy equal;
  - a BatchedDetector sharded over a world-1 NCCL group gives the unsharded
    detector's events and scores on the card bit for bit (the same kernels
    on the same shapes), K1 launching once per chunk, and the collectives
    return the local values.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.parallel.collectives import fleet_detection_count, gather_detections
from rustpotter_tpu_torch.parallel.mesh import make_stream_group, multihost_initialize
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream, training_wavs
from rustpotter_tpu_torch.wakewords.trainer import WakewordModelTrainOptions, train_from_buffers

EARLY = dict(rtol=2e-4, atol=2e-5)
LATE = dict(rtol=5e-3, atol=5e-4)
B_CARD = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
def test_training_on_card_matches_cpu(cuda_device):
    samples, tests = training_wavs(42, 12, seed=0), training_wavs(45, 6, seed=1)
    opts = WakewordModelTrainOptions(epochs=60)
    runs = {}
    for dev in (cuda_device, "cpu"):
        hist = {}
        model = train_from_buffers(opts, samples, tests, device=dev, verbose=False,
                                   history_out=hist)
        runs[str(dev)] = (model, hist)
    (mg, hg), (mc, hc) = runs["cuda"], runs["cpu"]
    assert mg.labels == mc.labels and mg.train_size == mc.train_size
    np.testing.assert_allclose(hg["loss"][:10], hc["loss"][:10], **EARLY)
    np.testing.assert_allclose(hg["loss"], hc["loss"], **LATE)
    assert hg["test_accuracy"] == hc["test_accuracy"]
    for k in mc.weights:
        np.testing.assert_allclose(mg.weights[k].to_numpy(), mc.weights[k].to_numpy(),
                                   **LATE, err_msg=k)


@pytest.mark.cuda
def test_world1_nccl_sharded_chunk_equals_unsharded(cuda_device, tmp_path):
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    stream = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(0).normal(0, 0.05, (len(stream), B_CARD, 480))
    frames = torch.tensor(frames.astype(np.float32), device=cuda_device)
    frames[:, 0] = torch.tensor(stream, device=cuda_device)
    multihost_initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device=cuda_device)
    try:
        sharding = make_stream_group()
        events = {}
        for name, sh in (("unsharded", None), ("sharded", sharding)):
            det = BatchedDetector([("w", ww)], cfg, batch_size=B_CARD, device=cuda_device,
                                  sharding=sh)
            states = det.init_states()
            before = fd.LAUNCHES["fused_dtw_v4"]
            evs = []
            for t in range(frames.shape[0]):
                states, ev = det.process_chunk(det.params, states, frames[t])
                evs.append([f.clone() for f in ev])
            torch.cuda.synchronize()
            assert fd.LAUNCHES["fused_dtw_v4"] - before == frames.shape[0]
            events[name] = evs
        for t, (a, b) in enumerate(zip(events["sharded"], events["unsharded"])):
            for f, g in zip(a, b):  # bit for bit (the gain is NaN, the normalizer off)
                if f.dtype.is_floating_point:
                    f, g = f.view(torch.int32), g.view(torch.int32)
                assert torch.equal(f, g), t
        fired = torch.stack([ev[0] for ev in events["sharded"]])
        assert fired[:, 0].any() and not fired[:, 1:].any()
        last = events["sharded"][-1]
        g_fired, g_score = gather_detections(sharding, last[0], last[2])
        assert torch.equal(g_fired, last[0]) and torch.equal(g_score, last[2])
        count = fleet_detection_count(sharding, fired[int(fired[:, 0].nonzero()[0])])
        assert int(count) == 1
    finally:
        dist.destroy_process_group()
