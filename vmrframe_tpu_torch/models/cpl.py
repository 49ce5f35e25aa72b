"""CPL, weakly supervised contrastive proposal learning (counterpart of
``vmrframe_tpu/models/cpl.py``).

A Gaussian proposal generator (a learned pooling over time, then 2P sigmoid
parameters a clip) defines P soft temporal proposals; a two-stage decoder
whose attention each proposal's Gaussian reweights reconstructs the query
words under each proposal (``layers/cpl_decoder.py``); training minimizes
the best proposal's reconstruction NLL plus a diversity penalty on the
Gaussians.  No boundary labels are read.  Inference takes each clip's
lowest-NLL proposal, span [center - width / 2, center + width / 2].

As in the JAX package: the trainable start vector is cast to the words'
dtype at the concat; the words' ``Dropout(0.1)`` and the decoders' 0.1 are
fixed (``model.droprate`` sets only ``VisualProjection``'s); the Gaussians
are computed in f32 and reach the attention in the activations' dtype.
``others.cpl_shared_prefix`` (True, "always", "eval", False) is a
formulation switch of the JAX package: every setting gives the same values,
and the port runs the shared-prefix path; ``others.cpl_remat`` changes no
value and is accepted and ignored.  CPL runs no hand-written kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.config import others
from vmrframe_tpu_torch.layers.basic import VisualProjection, WordEmbedding
from vmrframe_tpu_torch.layers.cpl_decoder import TransformerDecoder
from vmrframe_tpu_torch.layers.dropout import Dropout, dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.losses import cal_nll_loss, div_loss_cpl, rec_loss_cpl
from vmrframe_tpu_torch.ops.precision import biased
from vmrframe_tpu_torch.registry import register_model

HARD_DROP = 0.1  # the words' and the decoders' fixed rate
SHARED_PREFIX = (True, False, "always", "eval")



def _num_props(cfg) -> int:
    return int(others(cfg, "cpl_num_props", 8))


def generate_gauss_weight(props_len: int, center, width, vmask) -> torch.Tensor:
    """(BP,) center and width in [0, 1] -> (BP, L) Gaussians over each clip's
    valid part, each scaled to a maximum of 1."""
    pos = torch.linspace(0, 1, props_len, device=center.device)[None, :]
    frac = vmask.sum(dim=1) / vmask.shape[1]
    c = (center * frac)[:, None]
    w = (width * frac).clamp_min(1e-2)[:, None] / 9
    weight = 0.3989422804014327 / w * torch.exp(-(pos - c).square() / (2 * w * w))
    return weight / weight.amax(dim=-1, keepdim=True)


class CPL(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        dim, word_dim, L = int(m.dim), int(m.word_dim), int(m.vlen)
        self.P = _num_props(cfg)
        shared = others(cfg, "cpl_shared_prefix", True)
        if shared not in SHARED_PREFIX:
            raise ValueError(f"others.cpl_shared_prefix {shared!r} is not one of {SHARED_PREFIX}")
        self.video_affine = VisualProjection(int(m.vdim), dim, float(m.droprate))
        self.word_emb = WordEmbedding(word_dim, word_vectors, 0.0)
        self.start_vec = nn.Parameter(torch.zeros(word_dim))
        self.words_drop = Dropout(HARD_DROP)
        self.word_fc_kernel = nn.Parameter(torch.zeros(word_dim, dim))
        self.word_fc_bias = nn.Parameter(torch.zeros(dim))
        self.conv1d_cw_kernel = nn.Parameter(torch.zeros(L, 1))
        self.conv1d_cw_bias = nn.Parameter(torch.zeros(1))
        self.fc_gauss_kernel = nn.Parameter(torch.zeros(dim, 2 * self.P))
        self.fc_gauss_bias = nn.Parameter(torch.zeros(2 * self.P))
        self.decoder1 = TransformerDecoder(2, dim, 4, HARD_DROP, cross=False)
        self.decoder2 = TransformerDecoder(2, dim, 4, HARD_DROP, cross=True)
        self.fc_comp_kernel = nn.Parameter(torch.zeros(dim, int(derived.num_words)))
        self.fc_comp_bias = nn.Parameter(torch.zeros(int(derived.num_words)))
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g, P = generator, self.P
        word_ids, tmask, vmask = batch["words_ids"], batch["tmasks"], batch["vmasks"]
        B, L = vmask.shape
        vfeat = self.video_affine(batch["vfeats"], g)

        words = self.word_emb(word_ids, g)
        start = self.start_vec.to(words.dtype)[None, None].expand(B, 1, -1)
        words = self.words_drop(torch.cat([start, words], dim=1), g)
        tfeat_long = biased(words @ self.word_fc_kernel, self.word_fc_bias)  # (B, T + 1, dim)
        lens = tmask.sum(dim=1).to(torch.int64) + 1  # the words and the start token
        tmask_long = (torch.arange(word_ids.shape[1] + 1, device=vmask.device)[None, :]
                      < lens[:, None]).to(vfeat.dtype)

        weakly = biased(torch.einsum("bld,lo->bod", vfeat, self.conv1d_cw_kernel).squeeze(1),
                        self.conv1d_cw_bias)  # (B, dim)
        gauss = torch.sigmoid(biased(weakly @ self.fc_gauss_kernel, self.fc_gauss_bias))
        gauss = gauss.reshape(B * P, 2)
        center, width = gauss[:, 0], gauss[:, 1]
        vmask_props = vmask.repeat_interleave(P, dim=0)
        gauss_weight = generate_gauss_weight(L, center.float(), width.float(),
                                             vmask_props.float())
        pos_weight = (gauss_weight / gauss_weight.amax(dim=-1, keepdim=True)).to(vfeat.dtype)

        enc_out = self.decoder1(None, None, vfeat, vmask, tgt_gauss_weight=pos_weight,
                                generator=g, n_props=P)
        out = self.decoder2(enc_out, vmask_props, tfeat_long[:, :-1], tmask_long[:, :-1],
                            src_gauss_weight=pos_weight, generator=g, n_props=P)
        return {
            "word_ids": word_ids,
            "words_mask": tmask_long[:, :-1],
            "words_logit": biased(out @ self.fc_comp_kernel, self.fc_comp_bias),  # (B P, T, V)
            "width": width,
            "center": center,
            "gauss_weight": gauss_weight,
            "vmask": vmask,
        }


def cpl_loss(outputs, batch, cfg) -> torch.Tensor:
    """The best proposal's reconstruction NLL plus the diversity penalty."""
    P = _num_props(cfg)
    rec = rec_loss_cpl(outputs["words_logit"], outputs["word_ids"], outputs["words_mask"], P)
    div = div_loss_cpl(outputs["gauss_weight"], P, float(others(cfg, "cpl_div_lambda", 0.15)),
                       float(others(cfg, "cpl_div_loss_alhpa", 1.0)))  # sic, the reference's key
    return rec + div


def cpl_infer(outputs, batch, cfg) -> torch.Tensor:
    """Each clip's lowest-NLL proposal (the first on ties), [c - w/2, c + w/2]
    clipped to [0, 1]."""
    P = _num_props(cfg)
    logit = outputs["words_logit"]
    nll, _ = cal_nll_loss(logit, outputs["word_ids"].repeat_interleave(P, dim=0),
                          outputs["words_mask"].repeat_interleave(P, dim=0))
    best = nll.reshape(-1, P).argmin(dim=-1)
    rows = torch.arange(best.shape[0], device=best.device)
    width = outputs["width"].reshape(-1, P)[rows, best]
    center = outputs["center"].reshape(-1, P)[rows, best]
    return torch.stack([(center - width / 2).clamp_min(0.0), (center + width / 2).clamp_max(1.0)],
                       dim=1)


register_model("CPL", loss_fn=cpl_loss, infer_fn=cpl_infer)(CPL)
