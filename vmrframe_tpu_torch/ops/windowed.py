"""Sliding-window maxima for the sparse 2D proposal maps (counterpart of
``vmrframe_tpu/ops/windowed.py``).

Every window length comes from the log2(L) power-of-two window maxima (a
sparse table): ``max(x[i .. i+n-1]) = max(pow2[j][i], pow2[j][i + n - 2**j])``
with ``2**j <= n``.  ``cell_segment_max_map`` stacks each diagonal's window
maxima into one (B, R, D) tensor and builds the (B, L, L, D) map with one
static gather, whose gradient autograd takes as the gather's transpose (the
JAX package writes that transpose as a custom VJP).

Gradients at ties: ``torch.maximum`` and ``jnp.maximum`` both give each
side half of a tied cotangent, so a window whose maximum is reached twice
routes it as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def pow2_window_maxes(x: torch.Tensor, max_window: int) -> List[torch.Tensor]:
    """[w0, w1, ...] of (B, L - 2**j + 1, D) with wj[:, i] = max(x[:, i : i + 2**j])."""
    win = [x]
    j = 0
    while (2 << j) <= max_window:
        p, step = win[j], 1 << j
        win.append(torch.maximum(p[:, : p.shape[1] - step], p[:, step:]))
        j += 1
    return win


def windowed_max(pow2: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """(B, L - n + 1, D): out[:, i] = max(x[:, i : i + n]), from the pow2 tables."""
    n = int(n)
    if n == 1:
        return pow2[0]
    j = n.bit_length() - 1  # the largest power of two <= n
    a = pow2[j]
    if (1 << j) == n:
        return a
    shift = n - (1 << j)
    return torch.maximum(a[:, : a.shape[1] - shift], a[:, shift:])


def all_windowed_maxes(x: torch.Tensor, lengths: Sequence[int]) -> Dict[int, torch.Tensor]:
    """The sliding maxima of every window length in ``lengths``, from shared tables."""
    if not len(lengths):
        return {}
    lengths = [int(n) for n in lengths]
    pow2 = pow2_window_maxes(x, max(lengths))
    return {n: windowed_max(pow2, n) for n in sorted(set(lengths))}


@functools.lru_cache(maxsize=None)
def cell_gather_meta(L: int, cells: Tuple[Tuple[int, int], ...]) -> Tuple[List[int], np.ndarray]:
    """(widths, idx): the window widths stacked (1 and each offset + 1) and
    the (L * L,) row of the stacked windows each map cell reads, R (the
    appended zero row) where the cell is not in the map.  ``cells``:
    ((offset, stride), ...) -- cell (i, i + offset) for i in range(0,
    L - offset, stride) holds max(x[i .. i + offset]); the diagonal is
    always in."""
    widths = sorted({1} | {int(o) + 1 for o, _ in cells})
    base, r = {}, 0
    for w in widths:
        base[w] = r
        r += L - w + 1
    idx = np.full((L, L), r, np.int64)
    ii = np.arange(L)
    idx[ii, ii] = base[1] + ii
    for o, s in cells:
        o, s = int(o), int(s)
        i = np.arange(0, L - o, s)
        idx[i, i + o] = base[o + 1] + i
    flat = idx.reshape(-1)
    used = flat[flat < r]
    if len(np.unique(used)) != len(used):
        raise ValueError("cells must be distinct")
    return widths, flat


def cell_segment_max_map(x: torch.Tensor, cells) -> torch.Tensor:
    """(B, L, D) -> (B, L, L, D): cell (i, i + o) = max(x[i .. i + o]) for
    (o, stride) in ``cells``, x on the diagonal, zeros elsewhere."""
    B, L, D = x.shape
    widths, idx = cell_gather_meta(L, tuple((int(o), int(s)) for o, s in cells))
    wins = all_windowed_maxes(x, widths)
    rows = torch.cat([wins[w] for w in widths] + [x.new_zeros(B, 1, D)], dim=1)
    return rows[:, torch.as_tensor(idx, device=x.device)].reshape(B, L, L, D)
