"""The distillation family on the QANet-block student (counterpart of
``vmrframe_tpu/models/distill.py``).

The student is BaseFast's skeleton with a shared encoder of 4 layers and no
dual attention, the match head and ``SeqPANPredictor``, its parameters at
the top level of the model as in the flax tree (``text_encoder``,
``video_affine``, ``vfeat_encoder``, ``q2v_attn``, ``v2q_attn``, ``cq_cat``,
``match_conv1d``, ``label_embs``, ``predictor``).  The variants:

- ``OneTeacher``: the student beside a whole SeqPAN, ``teacher_t0``, built
  on the model's own config and trained jointly; loss = the teacher's hard
  losses + the student's + the batch mean of ``lossfun_softloc``.
- ``OneTeacher_SoftLabel`` and ``BaseFast_BAN_CoTrain``: the student beside a
  frozen SeqPAN, ``teach_model``, built on the config with
  ``teacher0.model`` as its model section (so the teacher's own droprate and
  ``fused_dual_stack`` apply) and loaded from ``teacher0.model.checkpoint``
  by ``load_teacher_hook``.  The optimizer holds every ``teach_model.``
  parameter fixed.  The teacher runs in the student's mode (dropout and the
  gumbel noise are live in a train step, as the JAX package passes
  ``deterministic`` through) under ``torch.no_grad()``: the JAX package's
  ``stop_gradient``, and no activations kept for a backward that never
  reaches the teacher.  Loss = the student's hard losses + softloc.
- ``BaseFast_BAN_PreTrain``: the student beside a frozen BAN,
  ``teach_model``, built and loaded as above (the BAN checkpoint's
  parameters; the teacher reads the student's default batch and takes its
  lengths from the masks); its curves are the row and column maxima of
  ``sigmoid(tmap) * mask2d``, the JAX package's conversion.  Loss as above.
- ``MultiTeacher``: the student alone, distilled from up to three teachers'
  curves shipped in the batch (``MultiTeacherBatcher``), each softloc term
  weighted by the IoU of the teacher's argmax span with the gt's.
- ``BaseFast_CCA_PreTrain``: the student alone, distilled from one teacher's
  curves shipped in the batch time-major (``CCAPreTrainBatcher``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
from torch import nn

from vmrframe_tpu_torch.config import Config
from vmrframe_tpu_torch.data.distill_batcher import CCAPreTrainBatcher, MultiTeacherBatcher
from vmrframe_tpu_torch.layers.dropout import dropout_bits, set_dropout_bits
from vmrframe_tpu_torch.layers.predictor import SeqPANPredictor
from vmrframe_tpu_torch.losses import _weighted_mean, lossfun_loc, lossfun_match, lossfun_softloc
from vmrframe_tpu_torch.models.ban import BAN
from vmrframe_tpu_torch.models.common import add_encoder_modules, encode_and_fuse
from vmrframe_tpu_torch.models.seqpan import SeqPAN, add_match_head, match_head, seqpan_infer
from vmrframe_tpu_torch.registry import register_model

logger = logging.getLogger(__name__)

TEACHER = "teach_model"  # the frozen teacher's submodule, and its parameters' prefix


class _Student(nn.Module):
    """The shared student tower; a variant adds its teacher beside it."""

    def __init__(self, cfg, derived, word_vectors):
        super().__init__()
        m = cfg.model
        add_encoder_modules(self, cfg, derived, word_vectors, shared_encoder=True,
                            encoder_layers=4, use_dual_attention=False)
        add_match_head(self, m.dim)
        self.predictor = SeqPANPredictor(m.dim, m.vlen, num_heads=4, droprate=m.droprate)
        set_dropout_bits(self, dropout_bits(cfg))

    def student(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        vmask = batch["vmasks"]
        _, _, fuse_feat = encode_and_fuse(self, batch, generator)
        fuse_feat, match_score, _, label_embs = match_head(self, fuse_feat, vmask, generator)
        slogits, elogits = self.predictor(fuse_feat, vmask, generator)
        return {"slogits": slogits, "elogits": elogits, "vmask": vmask,
                "match_score": match_score, "label_embs": label_embs}

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return self.student(batch, generator)


def _teacher_cfg(cfg) -> Config:
    """The teacher's config: the model's, with ``teacher0.model`` as its
    model section."""
    data = cfg.to_dict()
    data["model"] = cfg.teacher0.model.to_dict()
    return Config(data)


def _student_hard_loss(outputs, batch, sample_mask):
    label1ds = batch["label1ds"]
    loc = lossfun_loc(outputs["slogits"], outputs["elogits"], label1ds[:, 0, :],
                      label1ds[:, 1, :], batch["vmasks"], sample_mask)
    match = lossfun_match(outputs["match_score"], outputs["label_embs"], batch["NER_labels"],
                          batch["vmasks"], sample_mask)
    return loc + match


def _mean_softloc(s, e, st, et, vmask, temperature, sample_mask):
    return _weighted_mean(lossfun_softloc(s, e, st, et, vmask, temperature), sample_mask)


# ------------------------------------------------------------- OneTeacher


class OneTeacher(_Student):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__(cfg, derived, word_vectors)
        self.teacher_t0 = SeqPAN(cfg, derived, word_vectors)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        teacher = self.teacher_t0(batch, generator)
        out = self.student(batch, generator)
        out.update({f"{key}_t0": teacher[key]
                    for key in ("slogits", "elogits", "match_score", "label_embs")})
        return out


def oneteacher_loss(outputs, batch, cfg) -> torch.Tensor:
    sample_mask = batch.get("sample_mask")
    teacher = {key: outputs[f"{key}_t0"]
               for key in ("slogits", "elogits", "match_score", "label_embs")}
    return (_student_hard_loss(teacher, batch, sample_mask)
            + _student_hard_loss(outputs, batch, sample_mask)
            + _mean_softloc(outputs["slogits"], outputs["elogits"], outputs["slogits_t0"],
                            outputs["elogits_t0"], batch["vmasks"], cfg.loss.temperature,
                            sample_mask))


register_model("OneTeacher", loss_fn=oneteacher_loss, infer_fn=seqpan_infer)(OneTeacher)


# --------------------------------------------- frozen-SeqPAN-teacher pair


class _FrozenSeqPANStudent(_Student):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__(cfg, derived, word_vectors)
        self.teach_model = SeqPAN(_teacher_cfg(cfg), derived, word_vectors)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        out = self.student(batch, generator)
        with torch.no_grad():
            teacher = self.teach_model(batch, generator)
        out["slogits_t0"], out["elogits_t0"] = teacher["slogits"], teacher["elogits"]
        return out


class OneTeacher_SoftLabel(_FrozenSeqPANStudent):
    pass


class BaseFast_BAN_CoTrain(_FrozenSeqPANStudent):
    """Despite the name, the reference's CoTrain variant has a frozen SeqPAN
    teacher."""


def softlabel_loss(outputs, batch, cfg) -> torch.Tensor:
    sample_mask = batch.get("sample_mask")
    return _student_hard_loss(outputs, batch, sample_mask) + _mean_softloc(
        outputs["slogits"], outputs["elogits"], outputs["slogits_t0"], outputs["elogits_t0"],
        batch["vmasks"], cfg.loss.temperature, sample_mask)


def teacher_frozen(name: str) -> bool:
    return name.startswith(TEACHER + ".")


@torch.no_grad()
def load_teacher_hook(trainer, cfg) -> None:
    """Copies ``teacher0.model.checkpoint`` (the port's ``.pt`` or a JAX
    ``.npz``, ``weights.read_checkpoint``) into the teacher's parameters in
    place, each cast to its parameter's type: the optimizer holds references
    to these tensors.  The checkpoint must hold every teacher parameter and
    nothing the teacher lacks; its buffers (the GloVe table) are the
    dataset's, as the JAX hook restores params only.  A missing or empty
    path leaves the seeded teacher, with a warning when a path was named."""
    from vmrframe_tpu_torch.weights import read_checkpoint

    path = str(cfg.teacher0.model.get("checkpoint", "") or "")
    if not path or not os.path.exists(path):
        if path:
            logger.warning("teacher checkpoint %s does not exist: the teacher keeps its seeded "
                           "weights", path)
        return
    teacher = getattr(trainer.model, TEACHER)
    state = read_checkpoint(path)
    params = dict(teacher.named_parameters())
    missing = sorted(set(params) - set(state))
    unknown = sorted(set(state) - set(teacher.state_dict()))
    if missing or unknown:
        raise ValueError(f"teacher checkpoint {path}: missing {missing[:3]}, unknown "
                         f"{unknown[:3]} ({len(missing)} and {len(unknown)} in all)")
    for name, p in params.items():
        p.copy_(state[name].to(p.dtype))


for _cls in (OneTeacher_SoftLabel, BaseFast_BAN_CoTrain):
    register_model(_cls.__name__, loss_fn=softlabel_loss, infer_fn=seqpan_infer,
                   frozen_filter=teacher_frozen, init_hook=load_teacher_hook)(_cls)


# ----------------------------------------------- frozen-BAN-teacher pair


class BaseFast_BAN_PreTrain(_Student):
    def __init__(self, cfg, derived, word_vectors):
        super().__init__(cfg, derived, word_vectors)
        self.teach_model = BAN(_teacher_cfg(cfg), derived, word_vectors)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        out = self.student(batch, generator)
        with torch.no_grad():
            teacher = self.teach_model(batch, generator)
            smap = torch.sigmoid(teacher["tmap"]) * teacher["map2d_mask"][None].float()
        out["slogits_t0"], out["elogits_t0"] = smap.amax(dim=2), smap.amax(dim=1)
        return out


register_model("BaseFast_BAN_PreTrain", loss_fn=softlabel_loss, infer_fn=seqpan_infer,
               frozen_filter=teacher_frozen, init_hook=load_teacher_hook)(BaseFast_BAN_PreTrain)


# ------------------------------------------------------------ MultiTeacher


class MultiTeacher(_Student):
    pass


def calculate_adapt_cof(t_label: torch.Tensor, gt_label: torch.Tensor) -> torch.Tensor:
    """(B,) IoU of the teacher's argmax span with the gt's, both (B, 2, L);
    argmax takes the first of tied maxima; a zero union counts as 1."""
    ts, te = t_label[:, 0].argmax(dim=1), t_label[:, 1].argmax(dim=1)
    gs, ge = gt_label[:, 0].argmax(dim=1), gt_label[:, 1].argmax(dim=1)
    inter = torch.minimum(te, ge) - torch.maximum(ts, gs)
    union = torch.maximum(te, ge) - torch.minimum(ts, gs)
    return (inter / torch.where(union == 0, torch.ones_like(union), union)).clamp(0.0, 1.0)


def multiteacher_loss(outputs, batch, cfg) -> torch.Tensor:
    """sigmoid(logits) into the loc loss and into each teacher's softloc,
    weighted by ``calculate_adapt_cof`` and ``loss.t{i}_cof``; a teacher
    whose curves the batch lacks (every eval batch) is skipped."""
    sample_mask = batch.get("sample_mask")
    label1ds, vmasks = batch["label1ds"], batch["vmasks"]
    s_sig, e_sig = torch.sigmoid(outputs["slogits"]), torch.sigmoid(outputs["elogits"])
    loss = lossfun_loc(s_sig, e_sig, label1ds[:, 0], label1ds[:, 1], vmasks, sample_mask)
    for t in ("t0", "t1", "t2"):
        t_lab = batch.get(f"label1d_{t}s")
        if t_lab is None:
            continue
        per = lossfun_softloc(s_sig, e_sig, t_lab[:, 0], t_lab[:, 1], vmasks,
                              cfg.loss.get(f"{t}_temperature"))
        term = _weighted_mean(calculate_adapt_cof(t_lab, label1ds) * per, sample_mask)
        loss = loss + term * cfg.loss.get(f"{t}_cof")
    return loss


register_model("MultiTeacher", loss_fn=multiteacher_loss, infer_fn=seqpan_infer,
               batcher_cls=MultiTeacherBatcher)(MultiTeacher)


# ------------------------------------------------- BaseFast_CCA_PreTrain


class BaseFast_CCA_PreTrain(_Student):
    pass


def cca_pretrain_loss(outputs, batch, cfg) -> torch.Tensor:
    """The student's hard losses + softloc against the batch's time-major
    teacher curves."""
    sample_mask = batch.get("sample_mask")
    t0 = batch["label1ds_t0"]
    return _student_hard_loss(outputs, batch, sample_mask) + _mean_softloc(
        outputs["slogits"], outputs["elogits"], t0[:, :, 0], t0[:, :, 1], batch["vmasks"],
        cfg.loss.temperature, sample_mask)


register_model("BaseFast_CCA_PreTrain", loss_fn=cca_pretrain_loss, infer_fn=seqpan_infer,
               batcher_cls=CCAPreTrainBatcher)(BaseFast_CCA_PreTrain)
