"""BackBoneActionFormer (counterpart of ``vmrframe_tpu/models/backbone_actionformer.py``):
BackBone's skeleton (a text encoder of its own, 4 encoder layers, dual
attention; ``models/common.py``, so ``model.fused_dual_stack`` runs the
stack as one launch of #4 in eval mode) with ActionFormer's
``ConvTransformerBackbone`` after the fusion: arch (2, 2, 3), windows
(5, 5, 5, -1), absolute position encoding, stochastic depth 0.1,
``max_len = vlen``, the banded kernels from ``pallas_min_len`` 512 on (so at
Charades' vlen 64 the window-5 attention takes the band-mask route, as in
the JAX package).  Only pyramid level 0 feeds the SeqPAN predictor; loc
loss only.

Types on the bf16 route (``train.compute_dtype: bfloat16``: rank >= 2
weights and the batch's features and masks in bf16, vectors f32), layer by
layer, as flax's promotion gives them in the JAX model:

- text and video embedding, encoders, the dual-attention stack (#4 or #2)
  and CQAttention (#3): bf16;
- the backbone's embedding convs and their LayerNorms: bf16;
- the absolute position table (f32) added to that bf16 x: f32 from here on;
- the stem and branch transformer blocks: f32, each reading its bf16
  weights promoted to f32 (``ops/precision.py::promoted_call``), so the
  window-5 attention, LayerNorms and MLPs run in f32;
- ``SeqPANPredictor`` on pyramid level 0: f32 on promoted weights, its two
  ``TopSelfAttention`` cores through #1 in f32 (``attention_tf32``);
- the logits come out f32.

In f32 every layer is f32 and the promotion is the identity."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.layers.actionformer import ConvTransformerBackbone
from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.models.backbone import backbone_loss
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.models.seqpan import seqpan_infer
from vmrframe_tpu_torch.ops.precision import promoted_call
from vmrframe_tpu_torch.registry import register_model


class BackBoneActionFormer(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors, shared_encoder=False)
        self.backbone = ConvTransformerBackbone(
            n_in=m.dim, n_embd=m.dim, n_head=4, n_embd_ks=3, max_len=m.vlen, arch=(2, 2, 3),
            mha_win_size=(5, 5, 5, -1), scale_factor=2, with_ln=True, path_pdrop=0.1,
            use_abs_pe=True)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=m.droprate)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        _, _, fuse_feat = encode_and_fuse(self, batch, generator)
        feats, masks = self.backbone(fuse_feat, batch["vmasks"], generator)
        vmask = masks[0]  # pyramid level 0 only
        slogits, elogits = promoted_call(self.predictor, feats[0].dtype, feats[0], vmask,
                                         generator)
        return {"slogits": slogits, "elogits": elogits, "vmask": vmask}


bbaf_loss = backbone_loss  # BackBone's loc loss
bbaf_infer = seqpan_infer


register_model("BackBoneActionFormer", loss_fn=bbaf_loss, infer_fn=bbaf_infer)(
    BackBoneActionFormer)
