"""The NN wakeword path of the PyTorch port (device="cpu") against the JAX
package on the CPU, module by module: the MLP zoo (`wakewords.nn`: layer
sizes, seeded init, TensorData weights, `forward` / `forward_tail`), the
inverse-similarity score map, the label/score logic `_nn_post`, the bundle's
NN fields, and the two first-layer forms of the stream steps,
`_nn_scores_one` (per shift) and `_nn_scores_chunk` (all 3 shifts of a
chunk against the pre-chunk window), over a sweep of the cursor that wraps.

All inputs are made from a seed with numpy. Tolerances: logits and NN
scores rtol 1e-4 / atol 1e-3 (measured on the CPU: max |d| of the logits
6.7e-6 in `forward`, 2.4e-6 per shift and 4.1e-6 per chunk, of scores
3.6e-7: both sides are fp32, in different summation orders); init_params
and the TensorData bytes bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustpotter_tpu.wakewords.nn as jax_nn
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu.ops.scoring import nn_inverse_similarity as jax_nn_inverse_similarity
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.runtime.stream_step import _nn_post as jax_nn_post
from rustpotter_tpu.runtime.stream_step import _nn_scores_chunk as jax_nn_scores_chunk
from rustpotter_tpu.runtime.stream_step import _nn_scores_one as jax_nn_scores_one
from rustpotter_tpu.wakewords.files import ModelType as JaxModelType
from rustpotter_tpu.wakewords.files import TensorData as JaxTensorData
from rustpotter_tpu.wakewords.files import WakewordModel as JaxWakewordModel
from rustpotter_tpu_torch import RustpotterConfig
from rustpotter_tpu_torch.ops.scoring import nn_inverse_similarity
from rustpotter_tpu_torch.runtime.bundle import NNMeta, build_bundle
from rustpotter_tpu_torch.runtime.stream_step import (
    _nn_post,
    _nn_scores_chunk,
    _nn_scores_one,
    chunk_constants,
)
from rustpotter_tpu_torch.wakewords import nn
from rustpotter_tpu_torch.wakewords.files import ModelType, WakewordModel

torch.set_num_threads(2)

NN_TOL = dict(rtol=1e-4, atol=1e-3)
TYPES = ["tiny", "small", "medium", "large"]


def jax_model(m: WakewordModel) -> JaxWakewordModel:
    """The JAX package's copy of a port WakewordModel (the same weight bytes)."""
    return JaxWakewordModel(
        labels=list(m.labels), train_size=m.train_size, mfcc_size=m.mfcc_size,
        m_type=JaxModelType(m.m_type.value),
        weights={k: JaxTensorData(bytes=v.bytes, dims=list(v.dims), d_type=v.d_type)
                 for k, v in m.weights.items()},
        rms_level=m.rms_level,
    )


def model(m_type, train_size, labels, seed, C=8):
    params = nn.init_params(ModelType(m_type), train_size * C, C, len(labels), seed)
    return WakewordModel(labels=list(labels), train_size=train_size, mfcc_size=C,
                         m_type=ModelType(m_type), weights=nn.params_to_tensor_data(params),
                         rms_level=0.05)


def tensors(params):
    return [(torch.tensor(w), torch.tensor(b)) for w, b in params]


@pytest.mark.parametrize("m_type", TYPES)
def test_init_params_and_layer_sizes_are_bit_equal(m_type):
    args = (480, 16, 3)
    assert nn.layer_sizes(ModelType(m_type), *args) == jax_nn.layer_sizes(JaxModelType(m_type), *args)
    got = nn.init_params(ModelType(m_type), *args, seed=7)
    want = jax_nn.init_params(JaxModelType(m_type), *args, seed=7)
    assert len(got) == len(want)
    for (w, b), (jw, jb) in zip(got, want):
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)


def test_tensor_data_round_trip_matches_jax():
    params = nn.init_params(ModelType.SMALL, 600, 10, 2, seed=2)
    got = nn.params_to_tensor_data(params)
    want = jax_nn.params_to_tensor_data(params)
    assert list(got) == list(want) == nn.weight_names(len(params) + 1)
    for k in got:
        assert (got[k].bytes, got[k].dims, got[k].d_type) == (
            want[k].bytes, want[k].dims, want[k].d_type), k
    for (w, b), (w2, b2) in zip(params, nn.params_from_tensor_data(got)):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(b, b2)


@pytest.mark.parametrize("m_type", TYPES)
def test_forward_and_forward_tail_match_jax(m_type):
    C, ts = 16, 60
    params = nn.init_params(ModelType(m_type), ts * C, C, 3, seed=11)
    x = np.random.default_rng(1).normal(0, 3, (9, ts * C)).astype(np.float32)
    got = nn.forward(tensors(params), torch.tensor(x)).numpy()
    want = np.asarray(jax_nn.forward(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **NN_TOL)
    hid = x @ params[0][0].T + params[0][1]  # the first layer's pre-activation
    got = nn.forward_tail(tensors(params), torch.tensor(hid)).numpy()
    want = np.asarray(jax_nn.forward_tail(params, jnp.asarray(hid)))
    np.testing.assert_allclose(got, want, **NN_TOL)


def test_nn_inverse_similarity_matches_jax():
    rng = np.random.default_rng(3)
    n1, n2 = rng.normal(0, 10, (2, 200)).astype(np.float32)
    got = nn_inverse_similarity(torch.tensor(n1), torch.tensor(n2),
                                torch.tensor(2.2, dtype=torch.float32)).numpy()
    want = np.asarray(jax_nn_inverse_similarity(jnp.asarray(n1), jnp.asarray(n2),
                                                jnp.float32(2.2)))
    np.testing.assert_allclose(got, want, **NN_TOL)


def _bundles(models, avg_threshold=0.2):
    """(port static, params, JAX static, params) of NN wakewords alone."""
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = avg_threshold
    wws = [(f"n{i}", m) for i, m in enumerate(models)]
    static, params = build_bundle(wws, cfg, "cpu")
    jstatic, jparams = jax_build_bundle([(k, jax_model(m)) for k, m in wws], jcfg)
    return static, params, jstatic, jparams


LABEL_SETS = {
    "none_last": ("w", "v", "none"),
    "none_first": ("none", "w"),
    "no_none": ("a", "b", "c"),
}
CRAFTED = np.array([
    [1.0, 3.0, 3.0],  # tie on the max: the LAST maximal label wins
    [3.0, 3.0, 1.0],
    [2.0, 2.0, 2.0],  # all equal: no 'other' prob, second = 0
    [5.0, -1.0, 4.0],  # min of the others is the second prob
    [-2.0, 7.0, 7.0],
    [0.5, 0.5, 9.0],
], np.float32)


@pytest.mark.parametrize("labels", list(LABEL_SETS))
@pytest.mark.parametrize("avg_threshold", [0.2, 0.0])
def test_nn_post_matches_jax_on_crafted_ties(labels, avg_threshold):
    lab = LABEL_SETS[labels]
    m = model("tiny", 30, lab, seed=1)
    static, params, jstatic, jparams = _bundles([m], avg_threshold)
    assert static.nn_meta == (NNMeta(30, lab, lab.index("none") if "none" in lab else -1,
                                     "tiny"),)
    logits = CRAFTED[:, : len(lab)]
    got = _nn_post(static, params, torch.tensor(logits), 0)
    want = jax.vmap(lambda lg: jax_nn_post(jstatic, jparams, lg, 0))(jnp.asarray(logits))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NN_TOL)
    assert got[3].shape == (len(logits), static.smax)


def test_bundle_nn_fields_match_jax():
    models = [model("small", 40, ("w", "none"), 2), model("medium", 36, ("a", "b", "none"), 3)]
    static, params, jstatic, jparams = _bundles(models)
    assert static.names == jstatic.names == ("n0", "n1")
    assert (static.n_dtw, static.smax, static.max_mfcc_frames) == (0, 3, 40)
    assert tuple(static.nn_meta) == tuple(
        NNMeta(m.train_size, m.labels, m.none_idx, m.m_type) for m in jstatic.nn_meta)
    assert len(params.nn_params) == len(jparams.nn_params) == 2
    for layers, jlayers in zip(params.nn_params, jparams.nn_params):
        for (w, b), (jw, jb) in zip(layers, jlayers):
            np.testing.assert_array_equal(w.numpy(), jw)
            np.testing.assert_array_equal(b.numpy(), jb)


@pytest.fixture(scope="module")
def scorer():
    """Two NN wakewords (train_size 20 and 26, so the first is zero-padded
    in a 26-frame window), a seeded window (F, C, B) and 3 new rows."""
    models = [model("small", 20, ("w", "none"), 5), model("medium", 26, ("a", "b", "none"), 6)]
    static, params, jstatic, jparams = _bundles(models)
    F, C, B = static.max_mfcc_frames, static.mfcc_size, 5
    rng = np.random.default_rng(4)
    win = rng.normal(0, 4, (F, C, B)).astype(np.float32)
    new = rng.normal(0, 4, (3, C, B)).astype(np.float32)
    return static, params, jstatic, jparams, win, new


def _assert_outs_close(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NN_TOL)


@pytest.mark.parametrize("rot", [0, 7, 23, 24, 25])  # 25 = F - 1: wraps every shift
@pytest.mark.parametrize("j", [0, 1])
def test_nn_scores_one_matches_jax(scorer, rot, j):
    static, params, jstatic, jparams, win, _ = scorer
    consts = chunk_constants(static, params)
    got = _nn_scores_one(static, params, consts, torch.tensor(win),
                         torch.tensor(rot, dtype=torch.int32), j)
    win_b = jnp.asarray(np.moveaxis(win, -1, 0))  # (B, F, C) per stream
    want = jax.vmap(lambda w: jax_nn_scores_one(jstatic, jparams, w, jnp.int32(rot), j))(win_b)
    _assert_outs_close(got, want)


@pytest.mark.parametrize("rot0", [0, 5, 22, 23, 24, 25])  # 23-25: the new rows wrap
@pytest.mark.parametrize("j", [0, 1])
def test_nn_scores_chunk_matches_jax(scorer, rot0, j):
    static, params, jstatic, jparams, win, new = scorer
    consts = chunk_constants(static, params)
    win_t = torch.tensor(win)
    got = _nn_scores_chunk(static, params, consts, win_t, torch.tensor(new),
                           torch.tensor(rot0, dtype=torch.int32), j)
    want = jax_nn_scores_chunk(jstatic, jparams, jnp.asarray(win), jnp.asarray(new),
                               jnp.int32(rot0), j)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_outs_close(g, w)
    np.testing.assert_array_equal(win_t.numpy(), win)  # the window is only read


def test_step_roofline_counts_nn_products_as_jax():
    from rustpotter_tpu.utils.profiling import step_roofline as jax_step_roofline
    from rustpotter_tpu_torch.utils.profiling import step_roofline

    models = [model("medium", 40, ("w", "none"), 2), model("large", 36, ("a", "b"), 3)]
    static, _, jstatic, _ = _bundles(models)
    got, want = step_roofline(static), jax_step_roofline(jstatic)
    assert (got.gemm_flops, got.vector_flops, got.hbm_bytes) == (
        want.mxu_flops, want.vpu_flops, want.hbm_bytes)
    sizes = [nn.layer_sizes(m.m_type, m.train_size * 8, 8, len(m.labels)) for m in models]
    assert got.gemm_flops > 3 * 2 * sum(a * b for s in sizes for a, b in zip(s[:-1], s[1:]))
