"""Model zoo; importing it registers each model (SeqPAN, BackBone, BaseFast,
ActionFormer, BackBoneActionFormer, the sentence variants
BackBoneBertSentence and BackBoneAlignFeature, BAN, CCA, CPL, and the
distillation family: OneTeacher, OneTeacher_SoftLabel, BaseFast_BAN_CoTrain,
BaseFast_BAN_PreTrain, MultiTeacher, BaseFast_CCA_PreTrain)."""

from vmrframe_tpu_torch.models import (actionformer, backbone, backbone_actionformer,  # noqa: F401
                                       ban, basefast, cca, cpl, distill, seqpan,
                                       sentence_variants)
