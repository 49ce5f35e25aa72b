"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``), held
to the JAX sharded step's semantics (``tests/test_dp_equivalence.py``): the
same global batch through two gloo processes and through one gives the same
losses (1e-6) and the same updated parameters (5e-4), at the configs'
droprate (dropout and the gumbel noise live: each process's draws are the
rows of the one-process draw).  SeqPAN and BAN at their test configs, on a
full batch and on a padded tail batch whose halves hold 5 and 0 valid
samples; ActionFormer's (stochastic depth live, its EMA loss normaliser
read from the whole batch); CCA's BatchNorm module with its statistics over
both processes.

The two processes are started once for the module, under a timeout of
their own, and each runs every case (``tests/_torch_ddp_worker.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import os
import socket
import subprocess
import sys

import pytest
import torch

import _torch_ddp_worker as W
from vmrframe_tpu_torch.layers.dropout import batch_rows, draw_rows
from vmrframe_tpu_torch.parallel import mesh

WORLD = 2
TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(world 1's results in this process, world 2's from rank 0)."""
    out = tmp_path_factory.mktemp("ddp") / "world2.pt"
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(WORLD), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": REPO}
        procs.append(subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                                    "_torch_ddp_worker.py"),
                                       str(out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return W.run_all(), torch.load(out, weights_only=False)


@pytest.mark.parametrize("case", list(W.CASES))
def test_two_processes_train_as_one(worlds, case):
    one, two = worlds[0][case], worlds[1][case]
    assert one["valid"] == two["valid"] == (5.0 if case.endswith("_tail") else one["valid"])
    torch.testing.assert_close(torch.tensor(two["losses"]), torch.tensor(one["losses"]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(two["ious"], one["ious"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, equal_nan=True)
    assert two["params"].keys() == one["params"].keys()
    for k, v in one["params"].items():
        if v.is_floating_point():
            torch.testing.assert_close(two["params"][k], v, rtol=5e-4, atol=5e-4,
                                       msg=lambda m, k=k: f"{k}: {m}")


def test_batchnorm_statistics_over_both_processes(worlds):
    one, two = worlds[0]["batchnorm"], worlds[1]["batchnorm"]
    for key in ("y", "running_mean", "running_var"):
        torch.testing.assert_close(two[key], one[key], rtol=1e-5, atol=1e-5)
    for key in ("x", "weight", "bias"):
        torch.testing.assert_close(two["grads"][key], one["grads"][key], rtol=1e-5, atol=1e-5)


def test_draws_are_rows_of_the_one_process_draw():
    """Per-sample and sample-major (B * T, ...) draws; a shape that is not
    the process's rows is drawn as it is."""
    draw = lambda s: torch.rand(s, generator=torch.Generator().manual_seed(3))  # noqa: E731
    whole = draw((8, 5))
    with batch_rows(4, 4, 8):
        torch.testing.assert_close(draw_rows(draw, (4, 5)), whole[4:])
        torch.testing.assert_close(draw_rows(draw, (12, 5)), draw((24, 5))[12:])
        torch.testing.assert_close(draw_rows(draw, (7, 5)), draw((7, 5)))
    torch.testing.assert_close(draw_rows(draw, (4, 5)), whole[:4])


def test_one_process_is_not_distributed():
    assert mesh.initialize_distributed() is False  # no torchrun variables here
    assert mesh.world() == 1 and mesh.rank() == 0 and not mesh.is_distributed()
    assert mesh.local_batch_slice(16) == (0, 16)
    batch = {"sample_mask": torch.ones(6), "vfeats": torch.zeros(6, 3), "pipeline_seed": 7,
             "table": torch.zeros(2, 6)}
    part = mesh.shard_batch(batch, 2, 3)
    assert part["vfeats"].shape == (3, 3) and part["table"].shape == (2, 6)
    assert part["pipeline_seed"] == 7
