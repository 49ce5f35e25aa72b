"""The SeqPAN family's shared skeleton (counterpart of
``vmrframe_tpu/models/common.py``): text and video embedding, feature
encoders, optional dual attention, CQAttention fusion.

``add_encoder_modules`` registers the sub-modules on the calling model, so
the model keeps the flat, reference-like parameter names of the flax tree;
``encode_and_fuse`` runs them.  SeqPAN and BaseFast share one
``vfeat_encoder`` between the modalities, BackBone has a ``tfeat_encoder``
of its own; BaseFast has no dual-attention blocks.

The dual-attention stack has two routes over one parameter tree: the module
path (four ``DualAttentionBlock`` calls, each through the
``fused_dual_attention`` kernel) and, with ``model.fused_dual_stack`` set,
the whole stack as one launch of ``kernels/dual_stack.py`` (eval mode
only, so #4 never runs in a train step).  ``model.droprate`` sets every
dropout site; the forward's ``generator`` reaches each of them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.kernels import counting
from vmrframe_tpu_torch.kernels.dual_stack import dual_attention_stack
from vmrframe_tpu_torch.layers.attention import CQAttention, CQConcatenate, DualAttentionBlock
from vmrframe_tpu_torch.layers.basic import Embedding, FeatureEncoder, VisualProjection


def use_fused_stack(m, deterministic: bool) -> bool:
    """The gate of the whole-stack kernel, with the JAX package's conditions:
    eval mode, ``model.fused_dual_stack`` set (off by default), D a multiple
    of 128 and heads dividing D.  Any truthy flag selects the fused route
    (the JAX package's ``"interpret"`` has no meaning here): on CPU tensors
    the wrapper then runs the plain version; on CUDA tensors it launches the
    kernel, or raises where its limit (``kernels/dual_stack.py::takes``: D
    128-1024 at every head count) refuses the shapes (D 1152 and up).  Inside
    ``kernels.counting_route`` the four block calls run, whose count is the
    flag-off route's (the stack's plain version multiplies more)."""
    if not deterministic or not bool(m.get("fused_dual_stack", False)) or counting():
        return False
    D, H = int(m.dim), int(m.num_heads)
    return D % 128 == 0 and H > 0 and D % H == 0


def add_encoder_modules(module: nn.Module, cfg, derived, word_vectors, *,
                        shared_encoder: bool = True, encoder_layers: int = 4,
                        use_dual_attention: bool = True) -> None:
    m = cfg.model
    module.model_cfg = m
    drop = float(m.droprate)
    module.text_encoder = Embedding(m.dim, m.word_dim, m.char_dim, derived.num_chars,
                                    word_vectors, drop)
    module.video_affine = VisualProjection(m.vdim, m.dim, drop)
    encoder = lambda: FeatureEncoder(m.dim, max_pos_len=m.vlen, kernel_size=7,  # noqa: E731
                                     num_layers=encoder_layers, droprate=drop)
    module.vfeat_encoder = encoder()
    if not shared_encoder:
        module.tfeat_encoder = encoder()
    if use_dual_attention:
        module.dual_attention_block_1 = DualAttentionBlock(m.dim, m.num_heads, drop)
        module.dual_attention_block_2 = DualAttentionBlock(m.dim, m.num_heads, drop)
    module.q2v_attn = CQAttention(m.dim, drop)
    module.v2q_attn = CQAttention(m.dim, drop)
    module.cq_cat = CQConcatenate(m.dim)


def encode_and_fuse(module: nn.Module, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None):
    """Returns (vfeat, tfeat, fuse_feat) on the video grid."""
    g = generator
    vmask, tmask = batch["vmasks"], batch["tmasks"]
    tfeat = module.text_encoder(batch["words_ids"], batch["char_ids"], g)
    vfeat = module.video_affine(batch["vfeats"], g)
    vfeat = module.vfeat_encoder(vfeat, g)
    tfeat = getattr(module, "tfeat_encoder", module.vfeat_encoder)(tfeat, g)
    if hasattr(module, "dual_attention_block_1"):
        blocks = (module.dual_attention_block_1, module.dual_attention_block_2)
        if use_fused_stack(module.model_cfg, not module.training):
            vfeat, tfeat = dual_attention_stack(vfeat, tfeat, vmask, tmask, blocks[0].stacks(),
                                                blocks[1].stacks(), int(module.model_cfg.num_heads))
        else:
            for block in blocks:
                vfeat, tfeat = (block(vfeat, tfeat, vmask, tmask, g),
                                block(tfeat, vfeat, tmask, vmask, g))
    t2v_feat = module.q2v_attn(vfeat, tfeat, vmask, tmask, g)
    v2t_feat = module.v2q_attn(tfeat, vfeat, tmask, vmask, g)
    return vfeat, tfeat, module.cq_cat(t2v_feat, v2t_feat, tmask)
