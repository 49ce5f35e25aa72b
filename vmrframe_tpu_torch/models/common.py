"""The SeqPAN skeleton's encoder and fusion (counterpart of
``vmrframe_tpu/models/common.py::encode_and_fuse``, module path only).

``add_encoder_modules`` registers the sub-modules on the calling model, so
the model keeps the flat, reference-like parameter names of the flax tree;
``encode_and_fuse`` runs them.  One ``vfeat_encoder`` serves both
modalities, and each dual-attention block runs in both directions.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from vmrframe_tpu_torch.layers.attention import CQAttention, CQConcatenate, DualAttentionBlock
from vmrframe_tpu_torch.layers.basic import Embedding, FeatureEncoder, VisualProjection


def add_encoder_modules(module: nn.Module, cfg, derived, word_vectors) -> None:
    m = cfg.model
    module.text_encoder = Embedding(m.dim, m.word_dim, m.char_dim, derived.num_chars,
                                    word_vectors)
    module.video_affine = VisualProjection(m.vdim, m.dim)
    module.vfeat_encoder = FeatureEncoder(m.dim, max_pos_len=m.vlen, kernel_size=7, num_layers=4)
    module.dual_attention_block_1 = DualAttentionBlock(m.dim, m.num_heads)
    module.dual_attention_block_2 = DualAttentionBlock(m.dim, m.num_heads)
    module.q2v_attn = CQAttention(m.dim)
    module.v2q_attn = CQAttention(m.dim)
    module.cq_cat = CQConcatenate(m.dim)


def encode_and_fuse(module: nn.Module, batch: Dict[str, torch.Tensor]):
    """Returns (vfeat, tfeat, fuse_feat) on the video grid."""
    vmask, tmask = batch["vmasks"], batch["tmasks"]
    tfeat = module.text_encoder(batch["words_ids"], batch["char_ids"])
    vfeat = module.video_affine(batch["vfeats"])
    vfeat = module.vfeat_encoder(vfeat)
    tfeat = module.vfeat_encoder(tfeat)
    for block in (module.dual_attention_block_1, module.dual_attention_block_2):
        vfeat, tfeat = (block(vfeat, tfeat, vmask, tmask), block(tfeat, vfeat, tmask, vmask))
    t2v_feat = module.q2v_attn(vfeat, tfeat, vmask, tmask)
    v2t_feat = module.v2q_attn(tfeat, vfeat, tmask, vmask)
    return vfeat, tfeat, module.cq_cat(t2v_feat, v2t_feat, tmask)
