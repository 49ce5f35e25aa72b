"""The port's SeqPAN slice as a whole against the JAX package, on the tiny
``tests/configs/charades_seqpan.yaml`` and its synthetic data:

- the same seed gives the same records and the same test-mode batches;
- the deterministic forward at f32: slogits, elogits and match_score within
  1e-4, the loss within 1e-4, and equal predicted spans;
- the port's Evaluator against ``Trainer.run_eval_epoch`` (equal IoUs,
  R1@{0.3,0.5,0.7} and mIoU);
- the port in bf16 against itself in f32, with the bar of
  ``test_mixed_precision.py::test_bf16_eval_close_to_f32``;
- an ``.npz`` of the JAX variables loads like the trees, strictly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from vmrframe_tpu.config import Derived as JDerived
from vmrframe_tpu.config import load_config as jload_config
from vmrframe_tpu.data.batcher import Batcher as JBatcher
from vmrframe_tpu.metrics import get_i345_mi as jget_i345_mi
from vmrframe_tpu.testing import make_synthetic_data as jmake_synthetic_data
from vmrframe_tpu.train.trainer import Trainer, TrainState
from vmrframe_tpu_torch.config import Derived, load_config
from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.metrics import get_i345_mi
from vmrframe_tpu_torch.models.seqpan import SeqPAN, seqpan_infer, seqpan_loss
from vmrframe_tpu_torch.testing import make_synthetic_data
from vmrframe_tpu_torch.train.evaluator import Evaluator
from vmrframe_tpu_torch.weights import from_jax_params, load_jax_params

CFG = os.path.join(os.path.dirname(__file__), "configs", "charades_seqpan.yaml")
ATOL = 1e-4


@pytest.fixture(scope="module")
def world():
    """Both frameworks' config, data and batches, and one JAX state."""
    jcfg, cfg = jload_config(CFG), load_config(CFG)
    jds, jstore = jmake_synthetic_data(jcfg, seed=0, n_train=16, n_test=24)
    ds, store = make_synthetic_data(cfg, seed=0, n_train=16, n_test=24)
    jder = JDerived(num_words=jds["n_words"], num_chars=jds["n_chars"],
                    num_train_steps=2, steps_per_epoch=2)
    der = Derived(num_words=ds["n_words"], num_chars=ds["n_chars"])
    jbatches = list(JBatcher(jds["test_set"], jstore, jcfg, jder, "test").epoch(seed=0))
    batches = list(Batcher(ds["test_set"], store, cfg, der).epoch())
    trainer = Trainer(jcfg, jder, jds["word_vector"])
    rng = jax.random.PRNGKey(0)
    init = jax.jit(lambda b: trainer.model.init({"params": rng, "dropout": rng, "gumbel": rng},
                                                b, True))
    variables = jax.device_get(init({k: v for k, v in jbatches[0].items() if k != "num_valid"}))
    constants = {k: v for k, v in variables.items() if k != "params"}
    state = TrainState(variables["params"], constants, None, np.zeros((), np.int32))
    return dict(jcfg=jcfg, cfg=cfg, jds=jds, ds=ds, jder=jder, der=der, jbatches=jbatches,
                batches=batches, trainer=trainer, state=state)


def test_synthetic_data_and_batches_match(world):
    jds, ds = world["jds"], world["ds"]
    for key in ("train_set", "test_set", "word_dict", "char_dict", "n_words", "n_chars"):
        assert ds[key] == jds[key], key
    np.testing.assert_array_equal(ds["word_vector"], jds["word_vector"])
    assert len(world["batches"]) == len(world["jbatches"]) == 2  # the second is partial
    for got, want in zip(world["batches"], world["jbatches"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_forward_loss_and_spans_match(world):
    jcfg, state = world["jcfg"], world["state"]
    entry, jmodel = world["trainer"].entry, world["trainer"].model
    model = SeqPAN(world["cfg"], world["der"], world["ds"]["word_vector"]).eval()
    load_jax_params(model, state.params, state.constants["constants"])
    for jbatch in world["jbatches"]:
        jb = {k: v for k, v in jbatch.items() if k != "num_valid"}
        variables = {"params": state.params, **state.constants}
        want = jmodel.apply(variables, jb, True)
        want_loss = entry.loss_fn(want, jb, jcfg)
        want_props = entry.infer_fn(want, jb, jcfg)
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
        with torch.no_grad():
            got = model(tb)
            got_loss = seqpan_loss(got, tb, world["cfg"])
            got_props = seqpan_infer(got, tb, world["cfg"])
        for key in ("slogits", "elogits", "match_score"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                       err_msg=key)
        np.testing.assert_allclose(float(got_loss), float(want_loss), atol=ATOL)
        np.testing.assert_array_equal(got_props.numpy(), np.asarray(want_props))


def _evaluator(world, dtype):
    cfg = world["cfg"].updated({"train.compute_dtype": dtype})
    ev = Evaluator(cfg, world["der"], world["ds"]["word_vector"], device="cpu")
    state = world["state"]
    ev.load_state_dict(from_jax_params(state.params, state.constants["constants"]))
    return ev


def test_evaluator_matches_trainer_eval_epoch(world):
    want_ious, want_meter, _ = world["trainer"].run_eval_epoch(world["state"],
                                                                iter(world["jbatches"]))
    got_ious, got_meter, _, props = _evaluator(world, "float32").run_eval_epoch(
        iter(world["batches"]), collect_props=True)
    assert len(got_ious) == len(want_ious) == 24 == len(props)
    np.testing.assert_allclose(got_ious, want_ious, atol=1e-6)
    np.testing.assert_allclose(got_meter.avg, want_meter.avg, atol=ATOL)
    np.testing.assert_allclose(get_i345_mi(got_ious), jget_i345_mi(want_ious), atol=1e-4)


def test_bf16_eval_close_to_f32(world):
    ious32, _, _ = _evaluator(world, "float32").run_eval_epoch(iter(world["batches"]))
    ev16 = _evaluator(world, "bfloat16")
    assert ev16.model.predictor.start_hidden.weight.dtype == torch.bfloat16
    assert ev16.model.predictor.start_hidden.bias.dtype == torch.float32  # rank-1 stays f32
    ious16, _, _ = ev16.run_eval_epoch(iter(world["batches"]))
    assert abs(np.mean(ious32) - np.mean(ious16)) < 0.1


def test_npz_checkpoint_and_strict_carry(world, tmp_path):
    """An ``.npz`` of the JAX variables (``/``-joined names, as
    ``tools/convert_torch.py::flatten_tree`` writes them) loads like the
    trees themselves; a missing or an extra leaf fails the strict load."""
    from vmrframe_tpu.tools.convert_torch import flatten_tree
    from vmrframe_tpu_torch.weights import load_checkpoint, load_npz

    state = world["state"]
    params, constants = state.params, state.constants["constants"]
    path = tmp_path / "seqpan.npz"
    np.savez(path, **flatten_tree({"params": params, "constants": constants}))
    want = from_jax_params(params, constants)
    got = load_npz(str(path))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    model = SeqPAN(world["cfg"], world["der"], world["ds"]["word_vector"])
    load_checkpoint(model, str(path))
    torch.testing.assert_close(model.predictor.start_hidden.weight,
                               torch.tensor(np.asarray(params["predictor"]["start_hidden"]
                                                       ["kernel"]).T))
    flat = flatten_tree(params)
    missing = {k: v for k, v in flat.items() if k != "predictor/end_dense/bias"}
    with pytest.raises(RuntimeError, match="end_dense.bias"):
        load_jax_params(model, missing, constants)
    with pytest.raises(RuntimeError, match="stray"):
        load_jax_params(model, {**flat, "stray/kernel": np.zeros((2, 2), np.float32)}, constants)
