"""The card's peak rates: the one place every tool reads them from.

An NVIDIA H100 SXM5 (80 GB HBM3): 989 TFLOP/s of dense bf16 tensor-core
work, 67 TFLOP/s of f32 on the CUDA cores (the port runs f32 without TF32),
3.35 TB/s of device memory.  ``bench_kernels``' bounds, ``bench_zoo``'s MFU
and the roofline tools' floors divide by them; the rates the card reaches
in practice are ``tools/roofline.py``'s probes.
"""

from __future__ import annotations

from typing import Union

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
PEAK_FLOPS = {str(dtype).split(".")[-1]: ops for dtype, ops in PEAK_OPS.items()}


def peak_ops(dtype: Union[torch.dtype, str]) -> float:
    """The dense peak for ``dtype`` (a torch dtype or its name); any type
    other than bf16 at the f32 peak."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.split(".")[-1], torch.float32)
    return PEAK_OPS.get(dtype, PEAK_OPS[torch.float32])
