"""BAN's loss and the gradient of every parameter in the port against the
JAX package, on the CPU, at 1e-4 (each gradient scaled by its largest
entry), on both routes at the tiny BAN test config and on the compact route
(the default) at the long config's structure cut to tiny widths.  The
worlds, weights and batches are ``test_torch_ban.py``'s; the test sits in a
file of its own because its cases are the slowest of BAN's (the JAX
gradient is taken op by op), and xdist's ``--dist loadfile`` gives each
file one worker.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax
import numpy as np
import pytest
import torch

from test_torch_ban import ATOL, _np, world
from vmrframe_tpu.registry import get_model_entry as jget_model_entry
from vmrframe_tpu_torch.registry import get_model_entry
from vmrframe_tpu_torch.weights import from_jax_params


@pytest.mark.parametrize("name,compact", [("tiny", True), ("tiny", False), ("long", True)])
def test_loss_and_grads_match_jax(name, compact):
    """The JAX gradient is taken op by op, not jitted, for the reason
    ``_jax_forward`` gives; the selected proposals are compared first, so a
    selection that flips fails as such and not as a gradient mismatch."""
    w = world(name, compact, "train_set")
    jentry, entry = jget_model_entry("BAN"), get_model_entry("BAN")
    v = w["variables"]

    def jloss(params):
        out = w["jmodel"].apply({**v, "params": params}, w["jb"], True)
        return jentry.loss_fn(out, w["jb"], w["jcfg"]), out["coarse_pred"]

    (want_loss, want_props), want_grads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    model = w["model"]
    named = dict(model.named_parameters())
    out = model(w["tb"])
    np.testing.assert_array_equal(_np(out["coarse_pred"]), np.asarray(want_props),
                                  err_msg="the selected proposals differ")
    loss = entry.loss_fn(out, w["tb"], w["cfg"])
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=ATOL, atol=ATOL)
    flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_grads), {})
    assert set(flat) == set(named)
    for key, jg in flat.items():
        g = grads[key]
        g = np.zeros(jg.shape, np.float32) if g is None else g.numpy()
        scale = max(float(np.abs(jg.numpy()).max()), 1e-6)
        np.testing.assert_allclose(g / scale, jg.numpy() / scale, atol=ATOL, err_msg=key)
    # the content stream reaches neither package's loss: no gradient here, zeros in JAX
    assert grads["boundary_aware.feature_transform_c.weight_ih_l0"] is None
    assert not flat["boundary_aware.feature_transform_c.weight_ih_l0"].any()
