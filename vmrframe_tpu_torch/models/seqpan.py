"""SeqPAN, the flagship model (counterpart of ``vmrframe_tpu/models/seqpan.py``),
in deterministic mode: the match head takes softmax(logits / 0.3) with no
gumbel noise, as the JAX package does in eval.  The stochastic branch waits
for the training slice.

    text  = Embedding(GloVe ‖ char-CNN)
    video = VisualProjection(vdim -> dim)
    both  = one shared FeatureEncoder
    2 x DualAttentionBlock (both directions), 2 x CQAttention, CQConcatenate
    match head: Conv1D(dim -> 4) -> softmax(/0.3) -> soft label embedding
    SeqPANPredictor -> start/end logits
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import Conv1D
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import lossfun_loc, lossfun_match
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.ops.span import infer_span_1d
from vmrframe_tpu_torch.registry import register_model

MATCH_TAU = 0.3


class SeqPAN(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors)
        self.match_conv1d = Conv1D(m.dim, 4)
        self.label_embs = nn.Parameter(torch.empty(m.dim, 4))
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        vmask = batch["vmasks"]
        _, _, fuse_feat = encode_and_fuse(self, batch)
        match_score = torch.softmax(self.match_conv1d(fuse_feat) / MATCH_TAU, dim=-1)
        match_probs = torch.log(match_score.clamp_min(1e-30))
        soft_label_embs = match_score @ self.label_embs.T  # (B, L, dim)
        fuse_feat = (fuse_feat + soft_label_embs) * vmask[:, :, None]
        slogits, elogits = self.predictor(fuse_feat, vmask)
        return {
            "slogits": slogits,
            "elogits": elogits,
            "vmask": vmask,
            "match_score": match_score,
            "match_probs": match_probs,
            "label_embs": self.label_embs,
        }


def seqpan_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    """loc + match loss."""
    sample_mask = batch.get("sample_mask")
    label1ds = batch["label1ds"]
    loc = lossfun_loc(outputs["slogits"], outputs["elogits"], label1ds[:, 0, :],
                      label1ds[:, 1, :], batch["vmasks"], sample_mask)
    match = lossfun_match(outputs["match_score"], outputs["label_embs"], batch["NER_labels"],
                          batch["vmasks"], sample_mask)
    return loc + match


def seqpan_infer(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    """(B, 2) fractional spans."""
    return infer_span_1d(outputs["slogits"], outputs["elogits"], outputs["vmask"])


register_model("SeqPAN", loss_fn=seqpan_loss, infer_fn=seqpan_infer)(SeqPAN)
