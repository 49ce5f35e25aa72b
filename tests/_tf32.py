"""TF32 rounding and the 3xTF32 product as the port's f32 tensor-core bodies
compute them (``csrc/mma_tf32.cuh``), for the CPU tests that emulate those
bodies' schedules (``test_torch_attention_f32_tiles.py`` for #1/#2,
``test_torch_banded_f32_tiles.py`` for #6/#7).

``tf32`` rounds as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, to 10 mantissa bits); ``split`` gives x as big = tf32(x) and small =
tf32(x - big); ``product`` sums a matrix product in 8-wide steps (the k of
``mma.m16n8k8``), each step's big.small, then small.big, then big.big
added to an f32 accumulator (or big.big alone: one TF32 pass).
"""

import torch

STEP = 8  # the k of mma.m16n8k8: the width of each product's step


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the nearest value with 10 mantissa bits, ties
    away from zero (adding half of the dropped 13 bits to the magnitude's
    bits and cutting them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the kernels sum it: in K steps of 8,
    each step's three TF32 products (or big.big alone with ``passes`` 1)
    added to an f32 accumulator in the kernels' order.  The steps' products
    are taken in one batched call each; only the accumulator's adds run in
    sequence."""
    pad = -a.shape[-1] % STEP  # zero columns add exact zeros
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    steps = a.shape[-1] // STEP
    (ab, as_), (bb, bs) = split(a), split(b)
    at = lambda x: x.unflatten(-1, (steps, STEP)).movedim(-2, -3)  # noqa: E731  (..., S, M, 8)
    bt = lambda x: x.unflatten(-2, (steps, STEP))  # noqa: E731  (..., S, 8, N)
    terms = [at(ab) @ bt(bs), at(as_) @ bt(bb)] if passes == 3 else []
    terms.append(at(ab) @ bt(bb))
    acc = torch.zeros(terms[0].shape[:-3] + terms[0].shape[-2:])
    for k in range(steps):
        for term in terms:
            acc = acc + term[..., k, :, :]
    return acc
