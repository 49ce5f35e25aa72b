"""ActionFormer, the single-stage anchor-free localizer wrapped for VMR
(counterpart of ``vmrframe_tpu/models/actionformer.py``): the forward in
eval and train mode (``module.train()``: stochastic depth and dropout
drawing from the ``generator`` argument, the banded kernels by
``pallas_min_len``),
the single-gt label assignment and loss (with the EMA loss normaliser
carried in ``extras``), the fast top-1 span inference (the registered
``infer_fn``) and the full protocol, ``actionformer_infer_full``: the top
``test_cfg.max_seg_num`` segments per video by (soft-)NMS over the whole
batch on its device (``ops/nms.py``), with voting, or a plain top-k when
``nms_method`` is ``"none"``.  ``backbone_type: conv`` builds the conv-only
backbone and ``fpn_type: fpn`` the FPN neck, as in the JAX package.  The
model has no text branch: the query is carried and unused.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vmrframe_tpu_torch.data.af_batcher import ActionFormerBatcher
from vmrframe_tpu_torch.layers.actionformer import (FPN1D, ConvBackbone, ConvHead,
                                                    ConvTransformerBackbone, FPNIdentity, Scale,
                                                    generate_points)
from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.ops.nms import batched_nms_1d, batched_seg_voting
from vmrframe_tpu_torch.registry import register_model


class ActionFormer(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        af = cfg.actionformer
        arch = tuple(af.backbone_arch)
        self.num_levels = arch[2] + 1
        win = af.n_mha_win_size
        win_list = [win] * self.num_levels if isinstance(win, int) else list(win)
        tc = af.train_cfg
        eval_len = af.get("pallas_min_len_eval")
        if af.backbone_type == "conv":
            self.backbone = ConvBackbone(af.input_dim, af.embd_dim, af.embd_kernel_size, arch,
                                         af.scale_factor, with_ln=af.embd_with_ln)
        else:
            self.backbone = ConvTransformerBackbone(
                n_in=af.input_dim, n_embd=af.embd_dim, n_head=af.n_head,
                n_embd_ks=af.embd_kernel_size, max_len=af.max_seq_len, arch=arch,
                mha_win_size=win_list, scale_factor=af.scale_factor, with_ln=af.embd_with_ln,
                path_pdrop=tc.droppath, use_abs_pe=af.use_abs_pe,
                use_rel_pe=bool(af.get("use_rel_pe", False)),
                pallas_min_len=int(af.get("pallas_min_len", 512)),
                pallas_min_len_eval=None if eval_len is None else int(eval_len),
                proj_pdrop=float(tc.get("dropout", 0.0)))
        if af.fpn_type == "fpn":
            self.neck = FPN1D(self.num_levels, af.embd_dim, af.fpn_dim, af.scale_factor,
                              with_ln=af.fpn_with_ln)
            head_in = af.fpn_dim
        else:
            self.neck = FPNIdentity(self.num_levels, af.embd_dim, with_ln=af.fpn_with_ln)
            head_in = af.embd_dim
        prior_bias = -math.log((1 - tc.cls_prior_prob) / tc.cls_prior_prob)
        self.cls_head = ConvHead(head_in, af.head_dim, af.num_classes, af.head_num_layers,
                                 af.head_kernel_size, af.head_with_ln, final_bias_init=prior_bias)
        self.reg_head = ConvHead(head_in, af.head_dim, 2, af.head_num_layers,
                                 af.head_kernel_size, af.head_with_ln)
        for lvl in range(self.num_levels):
            setattr(self, f"scale_{lvl}", Scale())
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        feats, masks = self.backbone(batch["feats"], batch["masks"], generator)
        feats, masks = self.neck(feats, masks)
        cls_logits = self.cls_head(feats, masks)
        offsets = [torch.relu(getattr(self, f"scale_{lvl}")(o))
                   for lvl, o in enumerate(self.reg_head(feats, masks))]
        return {
            "cls_logits": torch.cat(cls_logits, dim=1),  # (B, P, C)
            "offsets": torch.cat(offsets, dim=1),  # (B, P, 2)
            "fpn_mask": torch.cat(masks, dim=1),  # (B, P)
        }


def _points(cfg) -> np.ndarray:
    """(P, 4) concat of the per-level (t, reg_min, reg_max, stride) buffers."""
    af = cfg.actionformer
    strides = [af.scale_factor ** i for i in range(af.fpn_start_level, af.backbone_arch[2] + 1)]
    pts = generate_points(af.max_seq_len, strides, af.regression_range)
    return np.concatenate([p[: af.max_seq_len // s] for p, s in zip(pts, strides)], axis=0)


def _points_on(cfg, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_points(cfg), device=like.device)


def label_points(points: torch.Tensor, gt_segments: torch.Tensor, cfg):
    """Single-gt label assignment over the batch.  points (P, 4); gt_segments
    (B, 2) in grid coordinates.  Returns cls_targets (B, P) and
    stride-normalised reg_targets (B, P, 2)."""
    af = cfg.actionformer
    t, stride = points[None, :, 0], points[None, :, 3]
    gt_s, gt_e = gt_segments[:, 0:1], gt_segments[:, 1:2]
    left, right = t - gt_s, gt_e - t
    if af.train_cfg.center_sample == "radius":
        center = 0.5 * (gt_s + gt_e)
        radius = af.train_cfg.center_sample_radius
        t_min = torch.maximum(center - stride * radius, gt_s)
        t_max = torch.minimum(center + stride * radius, gt_e)
        inside = torch.minimum(t - t_min, t_max - t) > 0
    else:
        inside = torch.minimum(left, right) > 0
    max_reg = torch.maximum(left, right)
    in_range = (max_reg >= points[None, :, 1]) & (max_reg <= points[None, :, 2])
    cls_targets = (inside & in_range).float()
    reg_targets = torch.stack([left, right], dim=-1) / stride[..., None]
    return cls_targets, reg_targets


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise focal loss."""
    p = torch.sigmoid(logits)
    ce = targets * _softplus(-logits) + (1 - targets) * _softplus(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def ctr_diou_loss_1d(pred, target, eps: float = 1e-8):
    """Elementwise 1D DIoU in the same-centre offset parameterisation."""
    lp, rp = pred[..., 0], pred[..., 1]
    lg, rg = target[..., 0], target[..., 1]
    intsctk = torch.minimum(lp, lg) + torch.minimum(rp, rg)
    unionk = (lp + rp) + (lg + rg) - intsctk
    iouk = intsctk / unionk.clamp_min(eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return 1.0 - iouk + torch.square(rho / len_c.clamp_min(eps))


def actionformer_init_extras(cfg) -> Dict[str, torch.Tensor]:
    return {"loss_normalizer": torch.tensor(float(cfg.actionformer.train_cfg.init_loss_norm),
                                            dtype=torch.float32)}


def actionformer_loss(outputs, batch, cfg, extras):
    """(final loss, new extras): focal cls loss with label smoothing plus the
    weighted DIoU reg loss on positives, both over the EMA normaliser."""
    af = cfg.actionformer
    tc = af.train_cfg
    cls_t, reg_t = label_points(_points_on(cfg, outputs["offsets"]), batch["gt_segments"], cfg)
    valid = outputs["fpn_mask"] * batch["sample_mask"][:, None]
    pos = cls_t * valid
    num_pos = pos.sum()
    momentum = 0.9
    loss_normalizer = momentum * extras["loss_normalizer"] \
        + (1 - momentum) * num_pos.clamp_min(1.0)
    ls = tc.label_smoothing
    gt_target = cls_t * (1 - ls) + ls / (af.num_classes + 1)
    cls_loss = (sigmoid_focal_loss(outputs["cls_logits"][..., 0], gt_target) * valid).sum() \
        / loss_normalizer
    reg_loss = (ctr_diou_loss_1d(outputs["offsets"], reg_t.clamp_min(0.0)) * pos).sum() \
        / loss_normalizer
    reg_loss = torch.where(num_pos == 0, torch.zeros_like(reg_loss), reg_loss)
    weight = tc.loss_weight if tc.loss_weight > 0 else 1.0
    final = cls_loss + reg_loss * weight
    if str(tc.get("engine_loss", "final")) == "reg":
        final = reg_loss
    return final, {"loss_normalizer": loss_normalizer}


def _decode_candidates(outputs, cfg):
    """Pre-NMS (segs, scores): scores below ``pre_nms_thresh`` or with a
    duration at most ``duration_thresh`` are zeroed (fixed shape)."""
    test = cfg.actionformer.test_cfg
    points = _points_on(cfg, outputs["offsets"])
    probs = torch.sigmoid(outputs["cls_logits"][..., 0]) * outputs["fpn_mask"]
    t, stride = points[None, :, 0], points[None, :, 3]
    seg_left = t - outputs["offsets"][..., 0] * stride
    seg_right = t + outputs["offsets"][..., 1] * stride
    segs = torch.stack([seg_left, seg_right], dim=-1)
    keep = (probs > test.pre_nms_thresh) & ((seg_right - seg_left) > test.duration_thresh)
    return segs, torch.where(keep, probs, torch.zeros_like(probs)), test


def _grid_to_seconds(segs, batch):
    """Grid -> seconds, clipped to [0, duration].  segs (B, ..., 2)."""
    expand = (slice(None),) + (None,) * (segs.dim() - 1)
    secs = (segs * batch["feat_stride"][expand] + 0.5 * batch["feat_num_frames"][expand]) \
        / batch["fps"][expand]
    return torch.minimum(secs.clamp_min(0.0), batch["duration"][expand])


def actionformer_infer(outputs, batch, cfg) -> torch.Tensor:
    """Top-1 span as duration fractions.  Greedy (soft-)NMS's first pick is
    the argmax of the pre-NMS scores, so the top-1 span is that segment,
    refined by voting where the config votes; a batch row whose scores are
    all zero gives the zero segment, as the NMS path does."""
    segs, scores, test = _decode_candidates(outputs, cfg)
    idx = torch.argmax(scores, dim=1)
    top = torch.gather(segs, 1, idx[:, None, None].expand(-1, 1, 2))  # (B, 1, 2)
    voting = float(test.get("voting_thresh", 0.0) or 0.0)
    if test.nms_method != "none" and voting > 0 and not bool(test.get("multiclass_nms", False)):
        top = batched_seg_voting(top, segs, scores, voting)
    any_valid = scores.amax(dim=1) > 0
    top = torch.where(any_valid[:, None, None], top, torch.zeros_like(top))
    return _grid_to_seconds(top[:, 0], batch) / batch["duration"][:, None]


def _decode_and_nms(outputs, cfg):
    """(segs (B, K, 2) grid coordinates, scores (B, K), valid (B, K)) with
    K = ``test_cfg.max_seg_num``, by decayed score: (soft-)NMS over the
    batch (``nms_method`` soft: gaussian, linear, else hard), then voting on
    the class-agnostic path where the config votes; ``"none"`` takes the K
    best pre-NMS scores, ties to the lower index, as ``lax.top_k``."""
    segs, scores, test = _decode_candidates(outputs, cfg)
    K = int(test.max_seg_num)
    if test.nms_method == "none":
        kept_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        kept_scores, idx = kept_scores[:, :K], idx[:, :K]
        kept_segs = torch.gather(segs, 1, idx[..., None].expand(-1, -1, 2))
        return kept_segs, kept_scores, kept_scores > 0
    method = {"soft": 2, "linear": 1}.get(test.nms_method, 0)
    kept_segs, kept_scores, valid = batched_nms_1d(segs, scores, test.iou_threshold, K,
                                                   test.min_score, method, test.nms_sigma)
    voting = float(test.get("voting_thresh", 0.0) or 0.0)
    if voting > 0 and not bool(test.get("multiclass_nms", False)):
        kept_segs = batched_seg_voting(kept_segs, segs, scores, voting)
    return kept_segs, kept_scores, valid


def actionformer_infer_full(outputs, batch, cfg) -> Dict[str, torch.Tensor]:
    """The full protocol: the top ``test_cfg.max_seg_num`` segments of each
    video, {'segments': (B, K, 2) seconds, 'scores': (B, K), 'valid': (B, K)},
    on the outputs' device."""
    kept_segs, kept_scores, valid = _decode_and_nms(outputs, cfg)
    return {"segments": _grid_to_seconds(kept_segs, batch), "scores": kept_scores,
            "valid": valid}


register_model(
    "ActionFormer",
    batcher_cls=ActionFormerBatcher,
    loss_fn=actionformer_loss,
    infer_fn=actionformer_infer,
    stateful=True,
    init_extras=actionformer_init_extras,
    optimizer_impl="tree",
)(ActionFormer)
