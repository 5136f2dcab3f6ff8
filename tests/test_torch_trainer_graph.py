"""The trainer's epochs in the form a CUDA graph can hold
(`wakewords/trainer.py` `sgd_epochs`, `fit`), on the CPU.

The data is made from a seed with numpy: 12 rows of 42 frames x 16 MFCCs
(672 inputs), two labels, the weights of `init_params` for each model type.

  (a) `sgd_epochs` keeps one set of parameter tensors (the same objects at
      the same addresses, the loss buffer too) and gives the losses and the
      weights of the loop it replaced, which made new leaf tensors every
      epoch (written out here as the oracle), bit for bit;
  (b) it reads nothing on the host: no Tensor.item, tolist, numpy, or
      conversion of a tensor to a Python bool, int or float;
  (c) `fit` on the CPU runs eagerly, in chunks of test_epochs with a
      shorter last chunk, and equals the oracle over all its epochs bit for
      bit, verbose or not; `GraphedStep` over `sgd_epochs` on CPU tensors is
      the eager call and captures nothing.
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.runtime.graph import GraphedStep
from rustpotter_tpu_torch.wakewords import trainer as pt
from rustpotter_tpu_torch.wakewords.files import ModelType
from rustpotter_tpu_torch.wakewords.nn import init_params

torch.set_num_threads(2)

FRAMES, MFCC, ROWS = 42, 16, 12
LR = 0.017
M_TYPES = [ModelType.TINY, ModelType.SMALL, ModelType.MEDIUM, ModelType.LARGE]


def _data(m_type, seed=0):
    """(host weights, x, y) from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (ROWS, FRAMES * MFCC)).astype(np.float32)
    y = np.arange(ROWS) % 2
    rng.shuffle(y)
    host = init_params(m_type, FRAMES * MFCC, MFCC, 2, seed)
    return host, torch.tensor(x), torch.tensor(y, dtype=torch.int64)


def new_leaf_loop(host, x, y, n):
    """The loop `sgd_epochs` replaced: new leaf tensors every epoch.
    Returns the flat parameters and the (n,) losses."""
    lr = torch.tensor(LR, dtype=torch.float32)
    params = [(torch.tensor(w).requires_grad_(), torch.tensor(b).requires_grad_())
              for w, b in host]
    losses = torch.empty(n, dtype=torch.float32)
    for e in range(n):
        flat = [t for wb in params for t in wb]
        loss = pt.nll_loss(params, x, y)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            new = [(p - lr * g).requires_grad_() for p, g in zip(flat, grads)]
            losses[e] = loss
        params = list(zip(new[0::2], new[1::2]))
    return [t for wb in params for t in wb], losses


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("m_type", M_TYPES, ids=lambda m: m.value)
@pytest.mark.parametrize("n", [1, 10])
def test_sgd_epochs_updates_one_set_of_tensors_as_the_new_leaf_loop(m_type, n):
    host, x, y = _data(m_type)
    consts = (y, torch.tensor(LR, dtype=torch.float32))
    state = pt.epoch_state(host, n, "cpu")
    ptrs = [t.data_ptr() for t in state]
    assert all(t.is_leaf and t.requires_grad for t in state[:-1])
    got, (losses,) = pt.sgd_epochs(consts, state, x)
    assert all(a is b for a, b in zip(got, state)) and losses is state[-1]
    assert [t.data_ptr() for t in got] == ptrs
    assert all(t.is_leaf and t.requires_grad for t in got[:-1])
    want_flat, want_losses = new_leaf_loop(host, x, y, n)
    assert _same_bits(losses, want_losses)
    assert all(_same_bits(a.detach(), b.detach()) for a, b in zip(got[:-1], want_flat))
    assert [tuple(w.shape) for w, _ in pt.layers(got)] == [w.shape for w, _ in host]
    # a second call goes on from where the first stopped
    pt.sgd_epochs(consts, state, x)
    want_flat, want_losses = new_leaf_loop(host, x, y, 2 * n)
    assert _same_bits(losses, want_losses[n:])
    assert all(_same_bits(a.detach(), b.detach()) for a, b in zip(state[:-1], want_flat))


@pytest.mark.parametrize("m_type", M_TYPES, ids=lambda m: m.value)
def test_sgd_epochs_reads_nothing_on_the_host(m_type, monkeypatch):
    """What a capture cannot hold (as tests/test_torch_graph.py checks the
    stream steps)."""
    host, x, y = _data(m_type, seed=1)
    consts = (y, torch.tensor(LR, dtype=torch.float32))
    state = pt.epoch_state(host, 3, "cpu")

    def host_read(self, *args, **kwargs):
        raise AssertionError("a host read inside the epochs")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    pt.sgd_epochs(consts, state, x)
    with pytest.raises(AssertionError, match="host read"):
        float(state[-1][0])
    monkeypatch.undo()
    assert torch.isfinite(state[-1]).all()


@pytest.mark.parametrize("verbose", [True, False])
@pytest.mark.parametrize("epochs,test_epochs", [(25, 10), (30, 10), (7, 10)])
def test_fit_on_the_cpu_is_the_eager_loop(verbose, epochs, test_epochs, capsys):
    host, x, y = _data(ModelType.MEDIUM, seed=2)
    params, history = pt.fit(host, x, y, x, y, LR, epochs, test_epochs, verbose=verbose)
    want_flat, want_losses = new_leaf_loop(host, x, y, epochs)
    assert _same_bits(torch.tensor(history, dtype=torch.float32), want_losses)
    got_flat = [t for wb in params for t in wb]
    assert all(_same_bits(a.detach(), b.detach()) for a, b in zip(got_flat, want_flat))
    lines = capsys.readouterr().out.splitlines()
    ends = list(range(test_epochs, epochs, test_epochs)) + [epochs]
    assert [int(ln.split()[0]) for ln in lines] == (ends if verbose else [])


def test_graphed_step_on_cpu_tensors_is_the_eager_call():
    host, x, y = _data(ModelType.SMALL, seed=3)
    consts = (y, torch.tensor(LR, dtype=torch.float32))
    step = GraphedStep(pt.sgd_epochs)
    s1, s2 = pt.epoch_state(host, 4, "cpu"), pt.epoch_state(host, 4, "cpu")
    for _ in range(2):
        s1, (l1,) = step(consts, s1, x)
        s2, (l2,) = pt.sgd_epochs(consts, s2, x)
        assert _same_bits(l1, l2)
    assert all(_same_bits(a.detach(), b.detach()) for a, b in zip(s1, s2))
    assert step.captures == 0
