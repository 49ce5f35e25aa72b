"""The sentence variants (counterpart of ``vmrframe_tpu/models/sentence_variants.py``).

- ``BackBoneBertSentence``: the GloVe/char text path replaced by ONE
  sentence vector per sample (``sentence_embeddings``, ``sentence_dim`` wide;
  its text mask ``tmasks_sentence`` is ones (B, 1)): ``text_affine``
  (a ``VisualProjection``) maps it to ``dim``, then BackBone's encoders, two
  dual-attention blocks in both directions, CQ attention, the match head
  and the predictor.  The text side has one position, so the dual
  attention's cross branch (video queries) and self branch (the text query)
  see one key, and CQ attention one query or one context row.
- ``BackBoneAlignFeature``: BackBone (GloVe/char text) plus an alignment
  head: the video features max-pooled over the inner moment
  (``inner_masks`` = NER label 2) BEFORE the dual attention; its loss adds
  the L1 distance of that vector to the sentence embedding, so ``model.dim``
  must equal ``sentence_dim`` (768 in the shipped config).

Both call their blocks directly, as the JAX models do, and not through
``models/common.py::encode_and_fuse``: the whole-stack kernel (#4) is not
on their path whatever ``model.fused_dual_stack`` says.  The sentence
vectors come from ``data/sentence_encoder.py`` (the hashed route; SBERT
waits for its weights).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from vmrframe_tpu_torch.data.batcher import Batcher
from vmrframe_tpu_torch.data.sentence_encoder import get_sentence_encoder
from vmrframe_tpu_torch.layers.attention import CQAttention, CQConcatenate, DualAttentionBlock
from vmrframe_tpu_torch.layers.basic import Embedding, FeatureEncoder, VisualProjection
from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import lossfun_loc
from vmrframe_tpu_torch.models.seqpan import (add_match_head, match_head, seqpan_infer,
                                              seqpan_loss)
from vmrframe_tpu_torch.registry import register_model


class SentenceBatcher(Batcher):
    """The base batch plus each sample's sentence embedding
    (``sentence_embeddings``, (B, ``sentence_dim``) f32) and ``inner_masks``
    (NER label 2, (B, vlen) f32).  Both need the host batch's NER labels,
    which the device pipeline's raw batch does not have: the JAX batcher
    fails there at its first batch, this one when it is built."""

    sentence_dim = 768
    single_token_text = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.device_pipeline:
            raise ValueError(f"{type(self).__name__} needs the host batch's NER labels, which "
                             "the device pipeline's raw batch does not have: turn "
                             "dataprocess.device_pipeline off for this model")
        self.encoder = get_sentence_encoder(self.sentence_dim)

    def make_batch(self, indices: List[int],
                   rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        batch = super().make_batch(indices, rng)
        B = self.batch_size
        emb = np.zeros((B, self.sentence_dim), dtype=np.float32)
        for slot, idx in enumerate(indices):
            emb[slot] = self.encoder.encode(self.dataset[idx]["sentence"])
        batch["sentence_embeddings"] = emb
        if self.single_token_text:
            batch["tmasks_sentence"] = np.ones((B, 1), dtype=np.float32)
        batch["inner_masks"] = (batch["NER_labels"] == 2).astype(np.float32)
        return batch


class BertSentenceBatcher(SentenceBatcher):
    single_token_text = True


def _add_fusion(module: nn.Module, m, drop: float) -> None:
    """The two dual-attention blocks, the two CQ attentions and CQConcatenate."""
    module.dual_attention_block_1 = DualAttentionBlock(m.dim, m.num_heads, drop)
    module.dual_attention_block_2 = DualAttentionBlock(m.dim, m.num_heads, drop)
    module.q2v_attn = CQAttention(m.dim, drop)
    module.v2q_attn = CQAttention(m.dim, drop)
    module.cq_cat = CQConcatenate(m.dim)


def _fuse(module: nn.Module, vfeat, tfeat, vmask, tmask, g):
    """Dual attention in both directions, twice, then the CQ fusion."""
    for block in (module.dual_attention_block_1, module.dual_attention_block_2):
        vfeat, tfeat = (block(vfeat, tfeat, vmask, tmask, g),
                        block(tfeat, vfeat, tmask, vmask, g))
    t2v = module.q2v_attn(vfeat, tfeat, vmask, tmask, g)
    v2t = module.v2q_attn(tfeat, vfeat, tmask, vmask, g)
    return module.cq_cat(t2v, v2t, tmask)


def _encoder(m, drop: float) -> FeatureEncoder:
    return FeatureEncoder(m.dim, max_pos_len=m.vlen, kernel_size=7, num_layers=4, droprate=drop)


class BackBoneBertSentence(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        drop = float(m.droprate)
        self.text_affine = VisualProjection(BertSentenceBatcher.sentence_dim, m.dim, drop)
        self.tfeat_encoder = _encoder(m, drop)
        self.video_affine = VisualProjection(m.vdim, m.dim, drop)
        self.vfeat_encoder = _encoder(m, drop)
        _add_fusion(self, m, drop)
        add_match_head(self, m.dim)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=drop)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g = generator
        vmask, tmask = batch["vmasks"], batch["tmasks_sentence"]
        tfeat = self.text_affine(batch["sentence_embeddings"][:, None, :], g)  # (B, 1, dim)
        tfeat = self.tfeat_encoder(tfeat, g)
        vfeat = self.vfeat_encoder(self.video_affine(batch["vfeats"], g), g)
        fuse_feat = _fuse(self, vfeat, tfeat, vmask, tmask, g)
        fuse_feat, match_score, _, label_embs = match_head(self, fuse_feat, vmask, g)
        slogits, elogits = self.predictor(fuse_feat, vmask, g)
        return {"slogits": slogits, "elogits": elogits, "vmask": vmask,
                "match_score": match_score, "label_embs": label_embs}


bertsentence_loss = seqpan_loss  # loc + match loss, as SeqPAN's


register_model("BackBoneBertSentence", loss_fn=bertsentence_loss, infer_fn=seqpan_infer,
               batcher_cls=BertSentenceBatcher)(BackBoneBertSentence)


class BackBoneAlignFeature(nn.Module):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        drop = float(m.droprate)
        self.text_encoder = Embedding(m.dim, m.word_dim, m.char_dim, derived.num_chars,
                                      word_vectors, drop)
        self.video_affine = VisualProjection(m.vdim, m.dim, drop)
        self.vfeat_encoder = _encoder(m, drop)
        self.tfeat_encoder = _encoder(m, drop)
        _add_fusion(self, m, drop)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=drop)
        set_dropout_bits(self, dropout_bits(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g = generator
        vmask, tmask = batch["vmasks"], batch["tmasks"]
        tfeat = self.text_encoder(batch["words_ids"], batch["char_ids"], g)
        vfeat = self.vfeat_encoder(self.video_affine(batch["vfeats"], g), g)
        tfeat = self.tfeat_encoder(tfeat, g)
        # the alignment vectors, before the dual attention
        tfeatalg = tfeat.amax(dim=1)
        vfeatalg = (vfeat * batch["inner_masks"][..., None].to(vfeat.dtype)).amax(dim=1)
        fuse_feat = _fuse(self, vfeat, tfeat, vmask, tmask, g)
        slogits, elogits = self.predictor(fuse_feat, vmask, g)
        return {"slogits": slogits, "elogits": elogits, "vmask": vmask,
                "tfeatalg": tfeatalg, "vfeatalg": vfeatalg}


def alignfeature_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                      cfg) -> torch.Tensor:
    """loc loss + the mean L1 distance of ``vfeatalg`` to the sentence
    embedding (over the valid samples)."""
    sample_mask = batch.get("sample_mask")
    label1ds = batch["label1ds"]
    loc = lossfun_loc(outputs["slogits"], outputs["elogits"], label1ds[:, 0, :],
                      label1ds[:, 1, :], batch["vmasks"], sample_mask)
    per = (outputs["vfeatalg"] - batch["sentence_embeddings"]).abs().mean(dim=-1)
    if sample_mask is not None:
        alg = (per * sample_mask).sum() / sample_mask.sum().clamp_min(1.0)
    else:
        alg = per.mean()
    return loc + alg


register_model("BackBoneAlignFeature", loss_fn=alignfeature_loss, infer_fn=seqpan_infer,
               batcher_cls=SentenceBatcher)(BackBoneAlignFeature)
