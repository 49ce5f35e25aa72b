"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``counting_route`` is the route a FLOP count reads (``tools/bench_zoo.py``):
inside it, a wrapper that launches its kernel also runs the kernel's plain
version on meta tensors of the launch's shapes, which an active
``torch.utils.flop_counter`` mode counts as it counts any torch operation
(the kernels are loaded through ``ctypes``, which it cannot see), and the
route switches that change how much arithmetic runs for the same function
are held at one setting (``models/common.py``, ``layers/actionformer.py``).
cuDNN and oneDNN are off inside it, so that the LSTMs run as the matrix
products of ATen's own recurrence, which the counter sees on the card and on
the CPU alike (cuDNN's and oneDNN's recurrences are single operations it
has no formula for).  The count is then the same whichever route a
config or a gate picks, on the card and on the CPU.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any

import torch

_counting = [False]  # a list, not a ContextVar: the autograd engine runs the backward elsewhere


def counting() -> bool:
    """Whether a ``counting_route`` is active."""
    return _counting[0]


@contextlib.contextmanager
def counting_route():
    """The route a FLOP count reads (module docstring); not re-entrant."""
    _counting[0] = True
    try:
        with warnings.catch_warnings():
            # putting oneDNN's flags back warns about TF32 on builds without Intel GPUs
            warnings.filterwarnings("ignore", message="TF32 acceleration on top of oneDNN")
            with torch.backends.cudnn.flags(enabled=False), \
                    torch.backends.mkldnn.flags(enabled=False):
                yield
    finally:
        _counting[0] = False


def _meta(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


def count_plain(plain, *args) -> None:
    """Inside ``counting_route``, runs ``plain`` on meta copies of ``args``:
    what a launch of its kernel adds to the count.  Elsewhere nothing."""
    if _counting[0]:
        plain(*(_meta(a) for a in args))
