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

A traffic count (``tools/roofline.py::count_traffic``) also reads each
kernel as one operation: ``kernel_traffic`` lets it see, wherever a wrapper
launches its kernel or (on CPU tensors) runs its plain version instead, the
tensors the kernel reads and writes, its plain version running beneath it
for the FLOPs.  ``launch_range`` names each launch in a profiler's trace
(``vmr::<wrapper>``), so that a trace can tell the launches apart by the
wrapper that made them; outside a profiler it does nothing.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any

import torch

_counting = [False]  # a list, not a ContextVar: the autograd engine runs the backward elsewhere
_holding = [False]


def counting() -> bool:
    """Whether a ``counting_route`` that holds the route switches is active."""
    return _counting[0] and _holding[0]


@contextlib.contextmanager
def counting_route(hold_routes: bool = True):
    """The route a FLOP count reads (module docstring); not re-entrant.
    ``hold_routes=False`` keeps the route switches and cuDNN as they are, so
    that a count reads the operations the step really runs (a traffic count
    against a trace); a launch still runs its plain version on meta tensors."""
    _counting[0], _holding[0] = True, hold_routes
    try:
        if not hold_routes:
            yield
            return
        with warnings.catch_warnings():
            # putting oneDNN's flags back warns about TF32 on builds without Intel GPUs
            warnings.filterwarnings("ignore", message="TF32 acceleration on top of oneDNN")
            with torch.backends.cudnn.flags(enabled=False), \
                    torch.backends.mkldnn.flags(enabled=False):
                yield
    finally:
        _counting[0] = _holding[0] = False


def _meta(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


_traffic = [None]  # the active traffic count's hook: (name, plain, args) -> plain's outputs


@contextlib.contextmanager
def kernel_traffic(hook):
    """While active, each kernel launch (and each plain version run in a
    wrapper's place on the CPU) calls ``hook(name, plain, args)``, which
    runs ``plain(*args)`` and returns its outputs; not re-entrant."""
    _traffic[0] = hook
    try:
        yield
    finally:
        _traffic[0] = None


def count_plain(plain, *args, name: str) -> None:
    """Inside ``counting_route``, runs ``plain`` on meta copies of ``args``:
    what a launch of its kernel adds to the count; ``args`` are the tensors
    the kernel reads.  Elsewhere nothing."""
    if _counting[0]:
        meta = tuple(_meta(a) for a in args)
        if _traffic[0] is not None:
            _traffic[0](name, plain, meta)
        else:
            plain(*meta)


def plain_route(name: str, plain, *args):
    """``plain(*args)``: a wrapper's route on CPU tensors, seen by an active
    traffic count as one launch of kernel ``name``."""
    with launch_range(name):
        if _traffic[0] is not None:
            return _traffic[0](name, plain, args)
        return plain(*args)


def launch_range(name: str):
    """A profiler range ``vmr::<name>`` while a profiler records, else a
    context that does nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"vmr::{name}")
    return contextlib.nullcontext()
