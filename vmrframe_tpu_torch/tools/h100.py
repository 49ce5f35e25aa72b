"""The card's peak rates: the one place every tool reads them from.

An NVIDIA H100 SXM5 (80 GB HBM3): 989 TFLOP/s of dense bf16 tensor-core
work, 67 TFLOP/s of f32 on the CUDA cores (the port's f32 route: no TF32
in cuBLAS), 495 TFLOP/s of dense TF32, 3.35 TB/s of device memory.  The
f32 bodies of #1/#2 and #5-#7 run their products on the tensor cores as
three TF32 products each (the 3xTF32 split), so their peak is a third of
TF32's.
``bench_kernels``' bounds, ``bench_zoo``'s MFU and the roofline tools'
floors divide by them; the rates the card reaches in practice are
``tools/roofline.py``'s probes.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
PEAK_FLOPS = {str(dtype).split(".")[-1]: ops for dtype, ops in PEAK_OPS.items()}
TF32X3_OPS = 495e12 / 3  # f32 products as three dense TF32 products each
# the hand-written kernels whose f32 products run in 3xTF32; not
# dual_attention_stack: its f32 attention does, but its f32 projections, most
# of its operations, run on the CUDA cores, so the f32 rate bounds it
TF32X3_KERNELS = ("fused_masked_attention", "fused_dual_attention", "banded_attention",
                  "banded_attention_dq", "banded_attention_dkv")


def peak_ops(dtype: Union[torch.dtype, str], kernel: Optional[str] = None) -> float:
    """The dense peak for ``dtype`` (a torch dtype or its name); any type
    other than bf16 at the f32 peak, but f32 in a kernel of
    ``TF32X3_KERNELS`` (``kernel``: its name, or its ``vmr::`` range's) at
    ``TF32X3_OPS``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.split(".")[-1], torch.float32)
    if dtype == torch.float32 and kernel is not None \
            and kernel.removeprefix("vmr::") in TF32X3_KERNELS:
        return TF32X3_OPS
    return PEAK_OPS.get(dtype, PEAK_OPS[torch.float32])
