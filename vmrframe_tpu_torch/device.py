"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def batch_to(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch's arrays as tensors on ``device`` (``num_valid`` stays
    behind; a device pipeline's ``pipeline_seed`` stays a host int, so that
    seeding its generator reads nothing back from the card)."""
    return {k: int(v) if k == "pipeline_seed" else torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if k != "num_valid"}


def strict_f32() -> None:
    """Make float32 on the card mean float32: torch lets cuDNN convolutions
    (and, if asked, matmuls) run in TF32, which keeps ~3 decimal digits.
    A process-wide setting, made by the entry points (the CLI, the
    profiler) before they build anything."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
