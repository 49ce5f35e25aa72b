"""The port's LSTM and windowed maxima against the JAX package, on the CPU:

- ``layers/recurrent.py::LSTM`` (``nn.LSTM`` over a packed sequence) against
  the JAX masked scan, with and without lengths, uni- and bidirectional, 1
  and 2 layers, at 1e-5, the flax leaves carried by ``weights.py``'s rule;
  ``masked_mean`` at 1e-6;
- ``all_windowed_maxes`` and ``cell_segment_max_map`` and their gradients at
  1e-6, on random inputs and on inputs with repeated values.

How max ties route their gradient: ``torch.maximum`` and ``jnp.maximum``
both give each side half of a tied cotangent, so the windowed maxima (every
window built from two overlapping halves, which tie whenever the maximum
lies in both) route it the same way in both packages.  A reduction is
different: ``jnp.max`` shares a tie evenly among all its maxima, as
``torch.amax`` does, while ``torch.max(dim)`` gives it all to the first
(``test_reduction_ties_route_as_jax``), so the port's reductions under a
gradient (``AdaptiveGCN``) use ``amax``.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmrframe_tpu.layers import recurrent as JR
from vmrframe_tpu.ops import windowed as JW
from vmrframe_tpu_torch.layers import recurrent as R
from vmrframe_tpu_torch.ops import windowed as W
from vmrframe_tpu_torch.weights import from_jax_params

B, T, D, H = 4, 12, 6, 5
LENGTHS = np.array([12, 7, 3, 1])


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_lstm_matches_jax(layers, bidirectional, with_lengths):
    rng = np.random.default_rng(layers * 4 + bidirectional * 2 + with_lengths)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = jnp.asarray(LENGTHS) if with_lengths else None
    jmod = JR.LSTM(hidden_dim=H, num_layers=layers, bidirectional=bidirectional)
    params = jmod.init(jax.random.PRNGKey(layers), jnp.asarray(x), lengths)["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), lengths))
    mod = R.LSTM(D, H, layers, bidirectional)
    state = from_jax_params(params, {})
    assert set(state) == set(mod.state_dict())  # weight_ih_l0, bias_hh_l1_reverse, ...
    mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = mod(_t(x), _t(LENGTHS) if with_lengths else None).numpy()
    assert got.shape == want.shape == (B, T, H * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if with_lengths:  # past a sample's length: zeros in both
        assert (got[3, 1:] == 0).all() and (got[2, 3:] == 0).all()


def test_masked_mean_matches_jax():
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    want = np.asarray(JR.masked_mean(jnp.asarray(x), jnp.asarray(LENGTHS)))
    np.testing.assert_allclose(R.masked_mean(_t(x), _t(LENGTHS)).numpy(), want, atol=1e-6)


def _inputs(kind: str, shape):
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        return rng.standard_normal(shape).astype(np.float32)
    # repeated values: ties within and across windows
    return rng.integers(0, 3, shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_all_windowed_maxes_and_grads_match_jax(kind):
    x = _inputs(kind, (2, 40, 3))
    lengths = [1, 2, 3, 5, 8, 13, 33, 40]
    cot = np.random.default_rng(9).standard_normal((sum(40 - n + 1 for n in lengths) * 6,))

    def jloss(v):
        wins = JW.all_windowed_maxes(v, lengths)
        return jnp.sum(jnp.concatenate([wins[n].reshape(-1) for n in lengths]) * cot)

    xt = _t(x).requires_grad_()
    wins = W.all_windowed_maxes(xt, lengths)
    jwins = JW.all_windowed_maxes(jnp.asarray(x), lengths)
    for n in lengths:
        np.testing.assert_allclose(wins[n].detach().numpy(), np.asarray(jwins[n]), atol=1e-6)
    loss = (torch.cat([wins[n].reshape(-1) for n in lengths]) * _t(cot).float()).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("cells", [((1, 1), (2, 1), (3, 1), (5, 1), (9, 1), (17, 1)),
                                   ((1, 1), (3, 2), (7, 4))])
def test_cell_segment_max_map_and_grad_match_jax(kind, cells):
    L = 24
    x = _inputs(kind, (2, L, 4))
    cot = np.random.default_rng(4).standard_normal((2, L, L, 4)).astype(np.float32)
    want = JW.cell_segment_max_map(jnp.asarray(x), cells)
    jgrad = jax.grad(lambda v: jnp.sum(JW.cell_segment_max_map(v, cells) * cot))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = W.cell_segment_max_map(xt, cells)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    (grad,) = torch.autograd.grad((got * _t(cot)).sum(), xt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6)
    off_map = np.ones((L, L), bool)  # cells outside the map are zero
    off_map[np.arange(L), np.arange(L)] = False
    for o, s in cells:
        i = np.arange(0, L - o, s)
        off_map[i, i + o] = False
    assert (got.detach().numpy()[:, off_map] == 0).all()


def test_reduction_ties_route_as_jax():
    """A row whose maximum is reached three times: JAX's ``jnp.max`` and
    torch's ``amax`` give each a third of the cotangent, ``torch.max(dim)``
    all of it to the first."""
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0]], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.max(v, axis=1)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    (amax_grad,) = torch.autograd.grad(xt.amax(dim=1).sum(), xt)
    (max_grad,) = torch.autograd.grad(xt.max(dim=1).values.sum(), xt)
    np.testing.assert_allclose(amax_grad.numpy(), want, atol=1e-7)
    np.testing.assert_allclose(want, [[0, 1 / 3, 1 / 3, 0, 1 / 3]], atol=1e-7)
    assert max_grad.numpy().tolist() == [[0, 1, 0, 0, 0]]
    # torch.maximum / jnp.maximum: halves
    a, b = _t(np.float32([2.0])).requires_grad_(), _t(np.float32([2.0])).requires_grad_()
    ga, gb = torch.autograd.grad(torch.maximum(a, b).sum(), (a, b))
    ja, jb = jax.grad(lambda p, q: jnp.sum(jnp.maximum(p, q)), (0, 1))(jnp.float32([2.0]),
                                                                       jnp.float32([2.0]))
    assert float(ga[0]) == float(gb[0]) == float(ja[0]) == float(jb[0]) == 0.5
