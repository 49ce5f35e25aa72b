"""Data parallelism's cases, run by ``tests/test_torch_ddp.py`` in one
process (world 1) and in two gloo processes (world 2).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p python tests/_torch_ddp_worker.py OUT

runs every case in ``CASES`` on this process's share and rank 0 writes the
results to OUT (``torch.save``).
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (config, padded tail): the first batch, or a batch of B with 5 valid
# samples, whose halves hold 5 and 0 of them
CASES = {
    "SeqPAN": ("tests/configs/charades_seqpan.yaml", False),
    "SeqPAN_tail": ("tests/configs/charades_seqpan.yaml", True),
    "BAN": ("tests/configs/charades_ban.json", False),
    "BAN_tail": ("tests/configs/charades_ban.json", True),
    # the EMA loss normaliser reads the whole batch's positives
    "ActionFormer": ("tests/configs/charades_actionformer.yaml", False),
}
N_STEPS = 2


def train_case(config: str, tail: bool) -> dict:
    """Two train steps from the seeded init on one global batch (dropout and
    the gumbel noise live at the config's droprate): losses, IoUs, the
    updated parameters."""
    from vmrframe_tpu_torch.config import Derived, load_config
    from vmrframe_tpu_torch.data.batcher import Batcher
    from vmrframe_tpu_torch.registry import get_model_entry
    from vmrframe_tpu_torch.testing import make_synthetic_data
    from vmrframe_tpu_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(REPO, config))
    B = int(cfg.train.batch_size)
    dataset, store = make_synthetic_data(cfg, seed=0, n_train=B + 5 if tail else B, n_test=B)
    derived = Derived(num_words=dataset["n_words"], num_chars=dataset["n_chars"],
                      num_train_steps=6, steps_per_epoch=2)
    batcher_cls = get_model_entry(str(cfg.model.name)).batcher_cls or Batcher
    batches = list(batcher_cls(dataset["train_set"], store, cfg, derived, "train")
                   .epoch(seed=0, shuffle=False))
    batch = batches[-1]
    trainer = Trainer(cfg, derived, dataset["word_vector"], device="cpu")
    device_batch = trainer.to_device(batch)
    losses, ious = [], []
    for _ in range(N_STEPS):
        out = trainer.train_step(device_batch)
        losses.append(float(out["loss"]))
        ious.append(out["ious"].clone())
    return {"losses": losses, "ious": ious, "valid": float(batch["sample_mask"].sum()),
            "params": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}}


def batchnorm_case() -> dict:
    """CCA's BatchNorm in train mode on a (8, 6, 6, 16) batch: the output,
    the running statistics and the gradients of a weighted sum."""
    from vmrframe_tpu_torch.models.cca import BatchNorm
    from vmrframe_tpu_torch.parallel import mesh

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, 6, 16, generator=g) * 2 + 0.5
    w = torch.randn(8, 6, 6, 16, generator=g)
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
    start, size = mesh.local_batch_slice(8)
    xs = x[start:start + size].clone().requires_grad_()
    y = bn(xs, deterministic=False)
    loss = (y * w[start:start + size]).sum()
    grads = dict(zip(("x", "weight", "bias"),
                     torch.autograd.grad(loss, (xs, bn.weight, bn.bias))))
    if mesh.is_distributed():  # the parameters' gradients summed, the rows gathered
        import torch.distributed as dist

        for k in ("weight", "bias"):
            dist.all_reduce(grads[k])
        y = mesh.gather_outputs({"y": y.detach()}, size)["y"]
        grads["x"] = mesh.gather_outputs({"x": grads["x"]}, size)["x"]
    return {"y": y.detach(), "grads": grads, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def run_all() -> dict:
    out = {name: train_case(*case) for name, case in CASES.items()}
    out["batchnorm"] = batchnorm_case()
    return out


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    from vmrframe_tpu_torch.parallel import mesh

    assert mesh.initialize_distributed("gloo")
    try:
        results = run_all()
        if mesh.rank() == 0:
            torch.save(results, sys.argv[1])
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
