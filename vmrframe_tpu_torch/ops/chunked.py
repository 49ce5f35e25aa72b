"""Chunked large-batch evaluation (counterpart of ``vmrframe_tpu/ops/chunked.py``).

``chunked_batch_apply`` runs a batch-wise function over fixed-size slices of
the batch's leading axis and concatenates the results: one large offline
batch through the program of a smaller one.  Whether the eval step on the
card needs it at all, that is whether it slows down per query past some
batch, is what ``tools/profile_batch.py`` measures (its ``--chunk``); no
default of the port calls it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils import _pytree as pytree


def chunked_batch_apply(fn: Callable[[Dict[str, Any]], Any], batch: Dict[str, Any],
                        batch_size: int, chunk: int = 256):
    """``fn`` (dict batch -> tree of tensors) applied to ``chunk``-sized
    slices of ``batch`` over the leading axis, the output trees concatenated.

    - tensors whose leading dimension equals ``batch_size`` are sliced;
      every other leaf goes to every chunk unchanged;
    - ``batch_size`` must be a multiple of ``chunk`` (callers pad the tail
      batch, as every batcher here does);
    - with ``batch_size <= chunk`` this is exactly ``fn(batch)``.

    ``fn`` must treat each sample on its own (no statistics across the
    batch), which is what makes the chunks' outputs the whole batch's."""
    if batch_size <= chunk:
        return fn(batch)
    assert batch_size % chunk == 0, (batch_size, chunk)
    sliced = {k for k, v in batch.items()
              if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == batch_size}
    outs = [fn({k: v[i:i + chunk] if k in sliced else v for k, v in batch.items()})
            for i in range(0, batch_size, chunk)]
    leaves, spec = zip(*(pytree.tree_flatten(o) for o in outs))
    return pytree.tree_unflatten([torch.cat(parts, dim=0) for parts in zip(*leaves)], spec[0])
