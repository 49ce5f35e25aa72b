"""SeqPAN, the flagship model (counterpart of ``vmrframe_tpu/models/seqpan.py``).
In eval mode the match head takes softmax(logits / 0.3) with no gumbel
noise, as the JAX package does; in train mode it adds gumbel noise drawn
from the forward's generator (``gumbel_noise``), and dropout is live at
``model.droprate`` (``train.dropout_bits`` wide).

    text  = Embedding(GloVe ‖ char-CNN)
    video = VisualProjection(vdim -> dim)
    both  = one shared FeatureEncoder
    2 x DualAttentionBlock (both directions), 2 x CQAttention, CQConcatenate
    match head: Conv1D(dim -> 4) -> softmax(/0.3) -> soft label embedding
    SeqPANPredictor -> start/end logits
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.layers.basic import Conv1D
from vmrframe_tpu_torch.layers.dropout import draw_rows, dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import lossfun_loc, lossfun_match
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.ops.span import infer_span_1d
from vmrframe_tpu_torch.registry import register_model

MATCH_TAU = 0.3
# parameters that shift every logit of a softmax by the same amount, so that
# their gradients are zero up to rounding: every attention key bias (a
# softmax over the keys) and, as the loc loss takes a softmax of the start
# and end logits over the positions (SeqPAN, BackBone), what adds one vector
# to every position's last features
SHIFT_INVARIANT = ("key.bias",) + tuple(
    f"{end}_{layer}.bias" for end in ("start", "end") for layer in ("layer_norm", "hidden",
                                                                    "dense"))


def add_match_head(module: nn.Module, dim: int) -> None:
    """Registers the match head's parameters on the calling model."""
    module.match_conv1d = Conv1D(dim, 4)
    module.label_embs = nn.Parameter(torch.empty(dim, 4))


def gumbel_noise(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """-log(-log U) in the logits' type, U uniform on [tiny, 1), as
    ``jax.random.gumbel(key, shape, dtype=logits.dtype)`` draws it."""
    if generator is None:
        raise ValueError("the match head in train mode needs the step's torch.Generator")
    tiny = torch.finfo(logits.dtype).tiny
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=logits.device,
                                       dtype=logits.dtype), logits.shape)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def match_head(module: nn.Module, fuse_feat, vmask, generator=None, tau: float = MATCH_TAU):
    """Conv1D(dim -> 4) -> softmax(/tau) (in train mode with gumbel noise
    added to the logits first) -> soft label-embedding injection.  Returns
    (fuse_feat', match_score, match_probs, label_embs); SeqPAN and BaseFast
    share it."""
    logits = module.match_conv1d(fuse_feat)
    if module.training:
        logits = logits + gumbel_noise(logits, generator)
    match_score = torch.softmax(logits / tau, dim=-1)
    match_probs = torch.log(match_score.clamp_min(1e-30))
    soft_label_embs = match_score @ module.label_embs.T  # (B, L, dim)
    fuse_feat = (fuse_feat + soft_label_embs) * vmask[:, :, None]
    return fuse_feat, match_score, match_probs, module.label_embs


class SeqPAN(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors)
        add_match_head(self, m.dim)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=m.droprate)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` feeds dropout and the gumbel noise in train mode."""
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
