"""Data parallelism over ``torch.distributed`` (counterpart of
``vmrframe_tpu/parallel/mesh.py``).

The JAX package splits a batch over a ``jax.sharding.Mesh``: parameters and
optimizer state replicated, the batch sharded on the ``data`` axis, and XLA
inserting the gradient all-reduce.  There is no torch object for
``make_mesh``, ``batch_sharding`` or ``replicated``; what takes their place:

- the mesh is the process group: ``rank()`` and ``world()``, one process a
  card (``torchrun --nproc_per_node N -m vmrframe_tpu_torch ...``), joined
  by ``initialize_distributed``;
- replicated: the parameters, the optimizer state and the step.  Every
  process builds the same seeded model (and loads the same checkpoints) and
  applies the same averaged gradient (``all_reduce_grads``), so they stay
  equal;
- sharded: the batch.  Every process assembles the same global batch and
  runs the forward on its rows (``local_batch_slice``, ``shard_batch``);
  the outputs are gathered back to the global batch with a differentiable
  all-gather (``gather_outputs``), and every process computes the loss,
  inference and IoU of the whole batch.  The losses that normalise by the
  global count of valid samples (``losses.py::_weighted_mean``) or read
  global statistics (ActionFormer's EMA normaliser) thus see what they see
  on one process, a padded tail batch included;
- BatchNorm's batch statistics are sums over every process's rows
  (``all_reduce_sum``, differentiable);
- random draws: a dropout mask, the gumbel noise and stochastic depth draw
  at the global batch's shape and keep this process's rows
  (``layers/dropout.py::draw_rows``), so they are the rows of the
  one-process draw.

The JAX helpers' optional 2D layout (``make_mesh(shape=...)``) has no
counterpart: nothing uses it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# outputs that are not per sample: the same on every process, not gathered
SHARED_OUTPUTS = frozenset({"label_embs", "map2d_mask"})


def initialize_distributed(backend: Optional[str] = None) -> bool:
    """Joins the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``):
    ``backend``, by default NCCL where a card is present and gloo
    elsewhere; under NCCL each process takes the card of its
    ``LOCAL_RANK``.  A no-op, returning False, without those variables or
    when a group is already joined."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ \
            or "MASTER_ADDR" not in os.environ or dist.is_initialized():
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_distributed() -> bool:
    """A process group is joined: the trainer's data-parallel route runs,
    its collectives at world 1 too."""
    return dist.is_available() and dist.is_initialized()


def local_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """(start, size) of this process's rows of the global batch."""
    n = world()
    if global_batch_size % n:
        raise ValueError(f"batch {global_batch_size} does not split over {n} processes")
    per = global_batch_size // n
    return rank() * per, per


def shard_batch(batch: Dict[str, torch.Tensor], start: int, size: int) -> Dict[str, torch.Tensor]:
    """The batch's rows [start, start + size): every tensor whose first
    dimension is the batch's (``sample_mask``'s); the others as they are."""
    total = batch["sample_mask"].shape[0]
    return {k: v[start:start + size] if isinstance(v, torch.Tensor) and v.dim()
            and v.shape[0] == total else v for k, v in batch.items()}


def gather_outputs(outputs: Dict[str, torch.Tensor], size: int) -> Dict[str, torch.Tensor]:
    """The model's outputs of every process's rows, concatenated in rank
    order (differentiable: a gradient goes back to the rows' process); the
    outputs in ``SHARED_OUTPUTS`` and scalars as they are."""
    from torch.distributed.nn.functional import all_gather

    out = {}
    for k, v in outputs.items():
        if k in SHARED_OUTPUTS or v.dim() == 0:
            out[k] = v
            continue
        if v.shape[0] % size:
            raise ValueError(f"output {k} {tuple(v.shape)} is not {size} samples' rows")
        out[k] = torch.cat(all_gather(v), dim=0)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


@torch.no_grad()
def all_reduce_grads(grads: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """Each gradient averaged over the processes, in one flat all-reduce.
    Every process computes the whole batch's loss, so autograd's sum over
    them (the gathers' backward) counts each process's rows ``world()``
    times; the mean undoes that.  A None (an unused parameter, the same on
    every process) stays None."""
    present = [k for k, g in grads.items() if g is not None]
    flat = torch.cat([grads[k].reshape(-1).float() for k in present])
    dist.all_reduce(flat)
    flat /= world()
    out, i = dict(grads), 0
    for k in present:
        g = grads[k]
        out[k] = flat[i:i + g.numel()].view_as(g).to(g.dtype)
        i += g.numel()
    return out

