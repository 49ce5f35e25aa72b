"""BackBone: SeqPAN without the sequence-matching head (counterpart of
``vmrframe_tpu/models/backbone.py``): a 4-layer text encoder of its own,
dual attention kept, loc loss only."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import lossfun_loc
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.models.seqpan import seqpan_infer
from vmrframe_tpu_torch.registry import register_model


class BackBone(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors, shared_encoder=False)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=m.droprate)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        vmask = batch["vmasks"]
        _, _, fuse_feat = encode_and_fuse(self, batch, generator)
        slogits, elogits = self.predictor(fuse_feat, vmask, generator)
        return {"slogits": slogits, "elogits": elogits, "vmask": vmask}


def backbone_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                  cfg) -> torch.Tensor:
    label1ds = batch["label1ds"]
    return lossfun_loc(outputs["slogits"], outputs["elogits"], label1ds[:, 0, :],
                       label1ds[:, 1, :], batch["vmasks"], batch.get("sample_mask"))


register_model("BackBone", loss_fn=backbone_loss, infer_fn=seqpan_infer)(BackBone)
