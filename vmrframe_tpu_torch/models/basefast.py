"""BaseFast: a SeqPAN ablation (counterpart of
``vmrframe_tpu/models/basefast.py``): no dual-attention blocks, a shared
encoder of 2 conv layers instead of 4, and a sigmoid on the logits before
the loc loss's soft cross-entropy."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import lossfun_loc, lossfun_match
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.models.seqpan import add_match_head, match_head, seqpan_infer
from vmrframe_tpu_torch.registry import register_model


class BaseFast(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors, encoder_layers=2,
                            use_dual_attention=False)
        add_match_head(self, m.dim)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=m.droprate)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        vmask = batch["vmasks"]
        _, _, fuse_feat = encode_and_fuse(self, batch, generator)
        fuse_feat, match_score, match_probs, label_embs = match_head(self, fuse_feat, vmask,
                                                                     generator)
        slogits, elogits = self.predictor(fuse_feat, vmask, generator)
        return {
            "slogits": slogits,
            "elogits": elogits,
            "vmask": vmask,
            "match_score": match_score,
            "match_probs": match_probs,
            "label_embs": label_embs,
        }


def basefast_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  cfg) -> torch.Tensor:
    """sigmoid(logits) into the soft CE, plus the match loss."""
    sample_mask = batch.get("sample_mask")
    label1ds = batch["label1ds"]
    loc = lossfun_loc(torch.sigmoid(outputs["slogits"]), torch.sigmoid(outputs["elogits"]),
                      label1ds[:, 0, :], label1ds[:, 1, :], batch["vmasks"], sample_mask)
    match = lossfun_match(outputs["match_score"], outputs["label_embs"], batch["NER_labels"],
                          batch["vmasks"], sample_mask)
    return loc + match


register_model("BaseFast", loss_fn=basefast_loss, infer_fn=seqpan_infer)(BaseFast)
