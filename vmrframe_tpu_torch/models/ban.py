"""BAN, the boundary-aware network over a 2D temporal proposal map
(counterpart of ``vmrframe_tpu/models/ban.py``).

BiLSTM video and query encoders -> BAN's CQAttention -> a cross BiLSTM ->
``TemporalDifference`` (boundary stream and its squared temporal
difference) -> the sparse 2D proposal map (start and end boundary terms plus
each span's segment maximum, projected) -> a coarse map score -> proposal
selection (top-k cells and their neighbours, stop-gradient) -> proposal
position encoding -> ``AdaptiveGCN`` blocks -> refine and offset heads.
The loss has five terms: map BCE, refine BCE, the temporal-difference CE,
SmoothL1 offsets and an InfoNCE contrast of map cells with the sentence.

Two routes over one parameter tree, as in the JAX package:

- compact cells (the default): only the K valid cells of the map
  (``mask2d``), in its row-major order, plus one sentinel cell carrying the
  value every invalid cell shares (``relu(bias)`` through the predictor),
  so the dense (B, L, L) score map is the sentinel's score with the K cells
  scattered in;
- dense (``model.compact_map: false``): the (B, L, L, F) map.

Both give the same values.  BAN runs no hand-written kernel: its LSTMs are
cuDNN's on the card, its windowed maxima and gathers plain torch.  Seven
dropout sites use rate 0.1 whatever ``model.droprate`` says (BANCQAttention,
the map, the two predictor heads' hidden layers and the offset head's), as
the JAX model hard-codes them; ``TemporalDifference``'s projections use
``model.droprate``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vmrframe_tpu_torch.data.ban_batcher import BANBatcher
from vmrframe_tpu_torch.data.labels import mask2d as build_mask2d
from vmrframe_tpu_torch.layers.dropout import Dropout, dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.recurrent import LSTM, masked_mean
from vmrframe_tpu_torch.ops.masking import mask_logits
from vmrframe_tpu_torch.ops.precision import biased
from vmrframe_tpu_torch.ops.span import triu_argmax_spans
from vmrframe_tpu_torch.ops.windowed import all_windowed_maxes, cell_segment_max_map
from vmrframe_tpu_torch.registry import register_model

HARD_DROP = 0.1  # the JAX model's fixed rate at seven sites
# BANCQAttention's scalar bias shifts every score: both softmaxes ignore it,
# so its gradient is zero up to rounding
SHIFT_INVARIANT = ("cqa_att.bias",)
PE_ROWS = 128  # rows of the proposal position table (so vlen <= 128)


# ---------------------------------------------------------------- layers


class BANQueryEncoder(nn.Module):
    """Frozen GloVe table (pad row 0, a learned unk row 1) + BiLSTM; returns
    (masked-mean sentence vector, word features)."""

    def __init__(self, hidden_dim: int, embed_dim: int, num_layers: int, word_vectors):
        super().__init__()
        self.unk_vec = nn.Parameter(torch.zeros(1, embed_dim))
        self.register_buffer("glove_vec", torch.tensor(np.asarray(word_vectors, np.float32)))
        self.biLSTM = LSTM(embed_dim, hidden_dim, num_layers, bidirectional=True)

    def forward(self, tokens, lengths):
        glove = self.glove_vec
        table = torch.cat([glove.new_zeros(1, glove.shape[1]), self.unk_vec.to(glove.dtype),
                           glove], dim=0)
        out = self.biLSTM(table[tokens.long()], lengths)
        return masked_mean(out, lengths), out


class BANVisualEncoder(nn.Module):
    """BiLSTM + masked-mean clip vector."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.biLSTM = LSTM(input_dim, hidden_dim, num_layers, bidirectional=True)

    def forward(self, x, lengths):
        out = self.biLSTM(x, lengths)
        return masked_mean(out, lengths), out


class BANCQAttention(nn.Module):
    """BAN's CQAttention: trilinear scores of dropped copies of C and Q plus
    a learned scalar bias; the row softmax masks the query, the column
    softmax masks nothing; returns [C, A, C * A, C * B]."""

    def __init__(self, d_model: int, dropout: float = HARD_DROP):
        super().__init__()
        self.w4C = nn.Parameter(torch.zeros(d_model, 1))
        self.w4Q = nn.Parameter(torch.zeros(d_model, 1))
        self.w4mlu = nn.Parameter(torch.zeros(1, 1, d_model))
        self.bias = nn.Parameter(torch.zeros(1))
        self.dropout = Dropout(dropout)

    def forward(self, C, Q, q_mask, generator=None):
        Cd, Qd = self.dropout(C, generator), self.dropout(Q, generator)
        S = Cd @ self.w4C + (Qd @ self.w4Q).transpose(1, 2) + (Cd * self.w4mlu) @ Qd.transpose(1, 2)
        S = biased(S, self.bias)
        S1 = torch.softmax(mask_logits(S, q_mask[:, None, :]), dim=2)
        S2 = torch.softmax(S, dim=1)
        A = S1 @ Q
        Bt = (S1 @ S2.transpose(1, 2)) @ C
        return torch.cat([C, A, C * A, C * Bt], dim=2)


class Linear(nn.Linear):
    """Dense layer whose f32 bias is added in the wider type and cast back."""

    def forward(self, x):
        return biased(x @ self.weight.t(), self.bias)


class MLPBlock(Linear):
    """Linear -> ReLU -> Dropout."""

    def __init__(self, in_dim: int, out_dim: int, droprate: float):
        super().__init__(in_dim, out_dim)
        self.dropout = Dropout(droprate)

    def forward(self, x, generator=None):
        return self.dropout(torch.relu(super().forward(x)), generator)


class TemporalDifference(nn.Module):
    """Boundary and content streams (2-layer BiLSTMs over the padded
    sequence, unmasked, each with its projection) and the boundary stream's
    squared one-step differences, both ends replicate-padded.  BAN reads
    only the boundary stream, so ``forward`` returns (hb, td): the content
    stream's parameters are in the tree (the JAX model computes it and
    leaves it unread, so their gradients are zero) but not run."""

    def __init__(self, input_dim: int, split_dim: int, droprate: float, layer_num: int = 2):
        super().__init__()
        self.feature_transform_b = LSTM(input_dim, split_dim, layer_num, bidirectional=True)
        self.feature_transform_c = LSTM(input_dim, split_dim, layer_num, bidirectional=True)
        self.feature_proj_b = MLPBlock(2 * split_dim, split_dim, droprate)
        self.feature_proj_c = MLPBlock(2 * split_dim, split_dim, droprate)

    def forward(self, x, generator=None):
        hb = self.feature_proj_b(self.feature_transform_b(x), generator)
        right = torch.cat([hb[:, 1:], hb[:, -1:]], dim=1) - hb
        left = torch.cat([hb[:, :1], hb[:, :-1]], dim=1) - hb
        return hb, (right.square() + left.square()).sum(dim=-1)


class AdaptiveGCN(nn.Module):
    """Edge convolution on the proposal graph: out_i = max_j relu(W [x_j - x_i, x_i]).
    The maximum is ``amax``: a tie shares its cotangent evenly, as JAX's
    ``jnp.max`` does (``torch.max(dim)`` would give it all to the first)."""

    def __init__(self, in_dim: int, hidden_size: int):
        super().__init__()
        self.fc = Linear(2 * in_dim, hidden_size)

    def forward(self, x):  # (B, N, D)
        diff = x[:, None, :, :] - x[:, :, None, :]  # [b, i, j] = x_j - x_i
        feat = torch.cat([diff, x[:, :, None, :].expand_as(diff)], dim=-1)
        return torch.relu(self.fc(feat)).amax(dim=2)


# ---------------------------------------------------------------- helpers


@functools.lru_cache(maxsize=None)
def _mask_meta(pooling_counts: Tuple[int, ...], L: int):
    """(mask2d, offsets, ii, jj): the validity mask, the diagonal offsets
    the pooling recipe reaches below L, and the valid cells in row-major
    order."""
    m = build_mask2d(L, list(pooling_counts))
    offsets = []
    stride, offset = 1, 0
    for c in pooling_counts:
        for _ in range(c):
            offset += stride
            if offset < L:
                offsets.append(offset)
        stride *= 2
    ii, jj = np.nonzero(m)
    return m, np.asarray(offsets), ii, jj


@functools.lru_cache(maxsize=None)
def _offset_major_perm(pooling_counts: Tuple[int, ...], L: int) -> np.ndarray:
    """The permutation from the offset-major stack of window maxima (the
    diagonal, then each offset's windows) to the row-major cell order."""
    _, offsets, ii, jj = _mask_meta(pooling_counts, L)
    om_i = np.concatenate([np.arange(L)] + [np.arange(L - o) for o in offsets])
    om_j = np.concatenate([np.arange(L)] + [np.arange(L - o) + o for o in offsets])
    lut = {(int(i), int(j)): k for k, (i, j) in enumerate(zip(om_i, om_j))}
    return np.asarray([lut[(int(i), int(j))] for i, j in zip(ii, jj)])


def _iou_cells(moments: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """IoU of (..., K, 2) grid spans with (..., 2) spans."""
    inter = torch.minimum(moments[..., 1], ref[..., 1:2]) - torch.maximum(moments[..., 0],
                                                                           ref[..., 0:1])
    union = torch.maximum(moments[..., 1], ref[..., 1:2]) - torch.minimum(moments[..., 0],
                                                                           ref[..., 0:1])
    return inter.clamp(min=0.0) / union


def _sinusoid_pe(max_len: int, dim: int) -> np.ndarray:
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


@torch.no_grad()
def proposal_selection(scores: torch.Tensor, moments: torch.Tensor, topk: int, neighbor: int,
                       negative: int, thresh: float) -> torch.Tensor:
    """(B, topk * (neighbor + 1) + negative) indices into the K cells, for
    (B, K) scores and (K, 2) cell spans: the JAX function's fixed-shape
    loop, batched.  Each of ``topk`` rounds takes the best unsuppressed
    cell (the first in stably sorted order), selects up to ``neighbor``
    later cells overlapping it above ``thresh`` and suppresses every
    overlapping one; the rest fill up from the best unsuppressed cells and
    ``negative`` of the worst.  Sorts are stable and ``argmax`` takes the
    first maximum, as ``jnp.argsort`` and ``jnp.argmax`` do."""
    B, K = scores.shape
    dev = scores.device
    order = torch.argsort(-scores, dim=1, stable=True)
    m_sorted = moments[order]  # (B, K, 2)
    ar = torch.arange(K, device=dev)
    rows = torch.arange(B, device=dev)
    suppressed = torch.zeros(B, K, dtype=torch.bool, device=dev)
    select = torch.zeros(B, K, dtype=torch.bool, device=dev)
    for _ in range(topk):
        i = torch.argmax((~suppressed).to(torch.uint8), dim=1)  # the first unsuppressed
        ious = _iou_cells(m_sorted, m_sorted[rows, i])
        overlap = (ious > thresh) & (ar[None, :] > i[:, None])
        select |= overlap & (torch.cumsum(overlap.long(), dim=1) <= neighbor)
        select[rows, i] = True
        suppressed |= overlap
        suppressed[rows, i] = True
    total = topk * (neighbor + 1)
    count = select.long().sum(dim=1, keepdim=True)
    un = ~suppressed
    pos_fill = un & (torch.cumsum(un.long(), dim=1) <= (total - count).clamp(min=0))
    neg_fill = un & (torch.cumsum(un.long().flip(1), dim=1).flip(1) <= negative)
    prio = torch.where(select, ar, torch.where(pos_fill | neg_fill, K + ar, 2 * K + ar))
    take = torch.argsort(prio, dim=1, stable=True)[:, : total + negative]
    return torch.gather(order, 1, take)


def _gcn_cfg(cfg):
    return cfg.model.gcn if cfg.model.get("gcn") is not None else cfg.gcn


# ---------------------------------------------------------------- model


class BAN(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        L, F_, dim = int(m.vlen), int(m.fuse_dim), int(m.dim)
        if L > PE_ROWS:
            raise ValueError(f"BAN's proposal position table has {PE_ROWS} rows: vlen {L}")
        self.compact = bool(m.get("compact_map", True))
        self.topk, self.neighbor, self.negative = int(m.topk), int(m.neighbor), int(m.negative)
        self.visual_encoder = BANVisualEncoder(m.vdim, dim, m.lstm_layer)
        self.query_encoder = BANQueryEncoder(dim, m.query_embed_dim, m.lstm_layer, word_vectors)
        self.cqa_att = BANCQAttention(F_)
        self.cross_encoder = BANVisualEncoder(4 * F_, dim, m.lstm_layer)
        self.boundary_aware = TemporalDifference(F_, F_, float(m.droprate), layer_num=2)
        self.map2d_proj_kernel = nn.Parameter(torch.zeros(3 * F_, F_))
        self.map2d_proj_bias = nn.Parameter(torch.zeros(F_))
        self.map_drop = Dropout(HARD_DROP)
        self.predictor_hidden = MLPBlock(F_, F_, HARD_DROP)
        self.predictor_out = Linear(F_, 1)
        C = int(m.contrast_dim)
        self.contrast_encoder_hidden = Linear(F_, C)
        self.contrast_encoder_out = Linear(C, C)
        self.contrast_encoder_t_hidden = Linear(2 * dim, C)
        self.contrast_encoder_t_out = Linear(C, C)
        self.prop_pe_fc = Linear(F_ + 2 * dim, F_)
        gcn = _gcn_cfg(cfg)
        for blk in range(int(gcn.num_blocks)):
            setattr(self, f"prop_interact_{blk}",
                    AdaptiveGCN(F_ if blk == 0 else int(gcn.hidden_size), int(gcn.hidden_size)))
        self.num_gcn = int(gcn.num_blocks)
        H = int(gcn.hidden_size)
        self.predictor2_hidden = MLPBlock(H, F_, HARD_DROP)
        self.predictor2_out = Linear(F_, 1)
        self.predictor_offset_hidden = MLPBlock(H, F_, HARD_DROP)
        self.predictor_offset_out = Linear(F_, 2)
        # static tables, on the model's device (not in the state dict)
        pooling = tuple(int(c) for c in m.pooling_counts)
        self.pooling = pooling
        mask_np, offsets, ii, jj = _mask_meta(pooling, L)
        self.offsets = [int(o) for o in offsets]
        buf = lambda name, value: self.register_buffer(name, value, persistent=False)  # noqa: E731
        buf("mask2d", torch.from_numpy(mask_np))
        buf("cells_i", torch.from_numpy(ii.astype(np.int64)))
        buf("cells_j", torch.from_numpy(jj.astype(np.int64)))
        buf("moments", torch.from_numpy(np.stack([ii, jj + 1], axis=1).astype(np.float32)))
        buf("perm", torch.from_numpy(_offset_major_perm(pooling, L).astype(np.int64)))
        buf("pe", torch.from_numpy(_sinusoid_pe(PE_ROWS, dim)))
        set_dropout_bits(self, dropout_bits(cfg))

    def _lengths(self, batch):
        """(vlens, tlens), from the batch's or from its masks (a teacher
        driven by another model's batcher)."""
        if "vlens" in batch:
            return batch["vlens"], batch["tlens"]
        vlens = batch["vmasks"].sum(dim=1).to(torch.int64).clamp(min=1)
        tlens = batch["tmasks"].sum(dim=1).to(torch.int64).clamp(min=1)
        return vlens, tlens

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g = generator
        vfeats, words = batch["vfeats"], batch["words_ids"]
        vlens, tlens = self._lengths(batch)
        tmask = (torch.arange(words.shape[1], device=words.device)[None, :]
                 < tlens[:, None]).to(vfeats.dtype)
        _, clip_feature = self.visual_encoder(vfeats, vlens)
        sentence_feature, word_feature = self.query_encoder(words, tlens)
        cat_feature = self.cqa_att(clip_feature, word_feature, tmask, g)
        _, fuse_feature = self.cross_encoder(cat_feature, vlens)
        hidden_b, td = self.boundary_aware(fuse_feature, g)

        B_, L, F_ = fuse_feature.shape
        W, b = self.map2d_proj_kernel, self.map2d_proj_bias
        W1, W2, W3 = W[:F_], W[F_:2 * F_], W[2 * F_:]
        A = hidden_b @ W1  # the start boundary term
        Bt = hidden_b @ W2  # the end boundary term
        ii, jj = self.cells_i, self.cells_j
        out: Dict[str, torch.Tensor] = {}
        if self.compact:
            wins = all_windowed_maxes(fuse_feature, [o + 1 for o in self.offsets])
            om_cells = torch.cat([fuse_feature] + [wins[o + 1] for o in self.offsets], dim=1)
            mapc_cells = om_cells[:, self.perm]  # (B, K, F), row-major
            K = mapc_cells.shape[1]
            zc = biased(A[:, ii] + Bt[:, jj] + mapc_cells @ W3, b)
            zc = torch.cat([zc, b.to(zc.dtype).expand(B_, 1, F_)], dim=1)  # + the sentinel
            map_cells = self.map_drop(torch.relu(zc), g)
            tmap_all = self.predictor_out(self.predictor_hidden(map_cells, g)).squeeze(-1)
            tmap_cells, t_inv = tmap_all[:, :K], tmap_all[:, K]
            tmap = t_inv[:, None, None].expand(B_, L, L).clone()
            tmap[:, ii, jj] = tmap_cells
            projc_all = self.contrast_encoder_out(torch.relu(self.contrast_encoder_hidden(
                torch.cat([mapc_cells, mapc_cells.new_zeros(B_, 1, F_)], dim=1))))
            out.update(tmap_cells=tmap_cells, map2d_proj_cells=projc_all[:, :K],
                       map2d_proj_inv=projc_all[:, K])
            cell_scores = torch.sigmoid(tmap_cells).detach()
        else:
            mask = self.mask2d[None, :, :, None]
            map2d_c = cell_segment_max_map(fuse_feature, [(o, 1) for o in self.offsets])
            map2d_c = map2d_c * mask.to(map2d_c.dtype)
            z = biased(A[:, :, None, :] + Bt[:, None, :, :]
                       + torch.einsum("bijf,fg->bijg", map2d_c, W3), b)
            z = torch.where(mask, z, b.to(z.dtype))
            map2d = self.map_drop(torch.relu(z), g)
            tmap = self.predictor_out(self.predictor_hidden(map2d, g)).squeeze(-1)
            out["map2d_proj"] = self.contrast_encoder_out(
                torch.relu(self.contrast_encoder_hidden(map2d_c)))
            cell_scores = torch.sigmoid(tmap).detach()[:, ii, jj]

        sen_proj = self.contrast_encoder_t_out(
            torch.relu(self.contrast_encoder_t_hidden(sentence_feature)))

        sel_idx = proposal_selection(cell_scores, self.moments, self.topk, self.neighbor,
                                     self.negative, thresh=0.7)  # (B, P)
        prop_i, prop_j = ii[sel_idx], jj[sel_idx]
        bidx = torch.arange(B_, device=fuse_feature.device)[:, None]
        if self.compact:
            prop_feature = torch.gather(map_cells[:, :-1], 1,
                                        sel_idx[..., None].expand(-1, -1, F_))
            pred_score = torch.gather(tmap_cells, 1, sel_idx)
        else:
            prop_feature = map2d[bidx, prop_i, prop_j]
            pred_score = tmap[bidx, prop_i, prop_j]
        if "start_end_offset" in batch:
            offset_gt = batch["start_end_offset"][bidx, prop_i, prop_j]
        else:
            offset_gt = torch.zeros(prop_i.shape + (2,), device=prop_i.device)
        pe = self.pe.to(prop_feature.dtype)
        prop_feature = self.prop_pe_fc(torch.cat([prop_feature, pe[prop_i], pe[prop_j]], dim=-1))
        for blk in range(self.num_gcn):
            prop_feature = getattr(self, f"prop_interact_{blk}")(prop_feature)
        pred = self.predictor2_out(self.predictor2_hidden(prop_feature, g)).squeeze(-1)
        offset = self.predictor_offset_out(self.predictor_offset_hidden(prop_feature, g))
        out.update(tmap=tmap, map2d_mask=self.mask2d, sen_proj=sen_proj,
                   coarse_pred=torch.stack([prop_i, prop_j + 1], dim=-1), final_pred=pred,
                   offset=offset, offset_gt=offset_gt, pred_score=pred_score, td=td,
                   vlens=vlens)
        return out


# ---------------------------------------------------------------- loss


def _smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _weighted(per, w):
    return (per * w).sum() / w.sum().clamp(min=1.0)


def ban_loss(outputs, batch, cfg) -> torch.Tensor:
    """The 5-term objective.  On the compact route the BCE and contrast
    terms read the valid-cell lists (every mask of those terms lies inside
    ``mask2d``, so the sums are the dense route's)."""
    lw = cfg.loss
    sample_mask = batch["sample_mask"]
    mask2d = outputs["map2d_mask"]
    iou_scaled = ((batch["iou2ds"] - lw.min_iou) / (lw.max_iou - lw.min_iou)).clamp(0, 1)
    tmap = outputs["tmap"]
    compact = "tmap_cells" in outputs
    if compact:
        _, _, ii, jj = _mask_meta(tuple(int(c) for c in cfg.model.pooling_counts), tmap.shape[-1])
        ii = torch.as_tensor(ii, device=tmap.device)
        jj = torch.as_tensor(jj, device=tmap.device)

    if compact:  # 1. coarse map BCE over the valid cells
        tc = outputs["tmap_cells"]
        iou_c = iou_scaled[:, ii, jj]
        per_cell = iou_c * F.softplus(-tc) + (1 - iou_c) * F.softplus(tc)
        loss_bce = _weighted(per_cell, sample_mask[:, None].expand_as(per_cell).to(tc.dtype))
    else:
        per_cell = iou_scaled * F.softplus(-tmap) + (1 - iou_scaled) * F.softplus(tmap)
        loss_bce = _weighted(per_cell, mask2d[None].to(tmap.dtype) * sample_mask[:, None, None])

    # 2. refine BCE of the sampled proposals against their scaled IoU
    pred_s_e = outputs["coarse_pred"]
    bidx = torch.arange(tmap.shape[0], device=tmap.device)[:, None]
    ious_gt = iou_scaled[bidx, pred_s_e[..., 0], pred_s_e[..., 1] - 1]
    fp = outputs["final_pred"]
    per_prop = ious_gt * F.softplus(-fp) + (1 - ious_gt) * F.softplus(fp)
    wp = sample_mask[:, None].expand_as(per_prop)
    loss_refine = _weighted(per_prop, wp)

    # 3. temporal difference
    td_mask = batch["dist_idxs"].sum(dim=1)
    td = torch.softmax(outputs["td"], dim=-1)
    numer = (td_mask * td.clamp(min=1e-30).log()).sum(dim=-1)
    per_sample_td = -numer / (td_mask.sum(dim=-1) + 1e-8)
    loss_td = _weighted(per_sample_td, sample_mask)

    # 4. offset SmoothL1
    off_p, off_g = outputs["offset"], outputs["offset_gt"]
    per = _smooth_l1(off_p[..., 0], off_g[..., 0]) + _smooth_l1(off_p[..., 1], off_g[..., 1])
    loss_offset = _weighted(per, wp)

    # 5. InfoNCE of positive against negative cells
    def safe_norm(x, eps=1e-8):
        return x / (x * x).sum(dim=-1, keepdim=True).clamp(min=eps * eps).sqrt()

    sen_n = safe_norm(outputs["sen_proj"])
    contrasts = batch["map2d_contrasts"]
    if compact:
        projc = outputs["map2d_proj_cells"]
        sim = torch.einsum("bkc,bc->bk", projc, sen_n) \
            / (projc * projc).sum(dim=-1).clamp(min=1e-16).sqrt()
        pos_m = contrasts[:, 0][:, ii, jj].bool()
        neg_m = contrasts[:, 1][:, ii, jj].bool()
        red = (1,)
    else:
        sim = torch.einsum("bijc,bc->bij", safe_norm(outputs["map2d_proj"]), sen_n)
        pos_m = contrasts[:, 0].bool() & mask2d[None]
        neg_m = contrasts[:, 1].bool() & mask2d[None]
        red = (1, 2)
    e = sim.exp()
    zero = e.new_zeros(())
    pos_exp = torch.where(pos_m, e, zero).sum(dim=red)
    all_exp = pos_exp + torch.where(neg_m, e, zero).sum(dim=red)
    has_both = (pos_m.sum(dim=red) > 0) & (neg_m.sum(dim=red) > 0)
    per_c = -(pos_exp / (all_exp + 1e-8) + 1e-30).log()
    loss_contrast = _weighted(per_c, has_both.to(per_c.dtype) * sample_mask)

    return (loss_bce * lw.bce + loss_refine * lw.refine + loss_td * lw.td
            + loss_offset * lw.offset + loss_contrast * lw.contrast)


def ban_infer(outputs, batch, cfg) -> torch.Tensor:
    """(B, 2) fractions: the argmax row and column of the raw map's upper
    triangle (no sigmoid, no mask2d), over the valid length; ties take the
    first, as ``jnp.argmax``."""
    return triu_argmax_spans(outputs["tmap"], outputs["vlens"])


register_model("BAN", loss_fn=ban_loss, infer_fn=ban_infer, batcher_cls=BANBatcher,
               optimizer_impl="tree")(BAN)
