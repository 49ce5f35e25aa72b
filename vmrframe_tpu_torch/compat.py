"""The reference's names on the port's modules (counterpart of
``vmrframe_tpu/compat.py``).

Users of the original PyTorch repository find the names they know
(``utils/engine.py``, ``models/loss.py``, ``utils/utils.py``) as thin
aliases of the port's own functions; new code imports the real modules.
"""

from __future__ import annotations

import numpy as np

from vmrframe_tpu_torch.data.datasets import load_json, load_pickle, save_pickle  # noqa: F401
from vmrframe_tpu_torch.data.labels import gaussian_weight as get_gaussian_weight  # noqa: F401
from vmrframe_tpu_torch.data.labels import mask2d as generate_2dmask  # noqa: F401
from vmrframe_tpu_torch.data.labels import soft_label as gene_soft_label  # noqa: F401
from vmrframe_tpu_torch.losses import (  # noqa: F401
    cal_nll_loss,
    div_loss_cpl,
    lossfun_loc,
    lossfun_loc2d,
    lossfun_match,
    lossfun_softloc,
    rec_loss_cpl,
)
from vmrframe_tpu_torch.metrics import (  # noqa: F401
    AverageMeter,
    append_ious,
    calculate_iou,
    calculate_iou_accuracy,
    frac_idx,
    get_i345_mi,
    idx_time,
    time_idx,
)
from vmrframe_tpu_torch.ops.masking import length_to_mask as convert_length_to_mask  # noqa: F401
from vmrframe_tpu_torch.ops.masking import mask_logits  # noqa: F401
from vmrframe_tpu_torch.ops.span import infer_span_1d as infer_basic  # noqa: F401
from vmrframe_tpu_torch.ops.span import infer_span_2d as infer_basic2d  # noqa: F401


def build_train_engine(model_name: str):
    """The reference's ``train_engine_<Name>``/``infer_<Name>`` pair by model
    name: the port registry's ``(loss_fn, infer_fn)``.  The whole step is
    ``train.trainer.Trainer.train_step``."""
    from vmrframe_tpu_torch.registry import get_model_entry

    entry = get_model_entry(model_name)
    return entry.loss_fn, entry.infer_fn


def iou_n1(candidates: np.ndarray, gt) -> np.ndarray:
    """IoU of (N, 2) candidate spans with one gt span."""
    from vmrframe_tpu_torch.data.labels import iou_1d

    return iou_1d(np.asarray(candidates, dtype=np.float64), gt)


def score2d_to_moments_scores(score2d: np.ndarray, num_clips: int, duration: float):
    """The nonzero cells of a 2D score map as (moments in seconds, scores)."""
    grids = np.argwhere(score2d)
    scores = score2d[grids[:, 0], grids[:, 1]]
    grids = grids.astype(np.float64)
    grids[:, 1] += 1
    return grids * duration / num_clips, scores
