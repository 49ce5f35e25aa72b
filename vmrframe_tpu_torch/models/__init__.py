"""Model zoo; importing it registers each model (SeqPAN, BackBone, BaseFast,
ActionFormer, and the distillation family: OneTeacher, OneTeacher_SoftLabel,
BaseFast_BAN_CoTrain, MultiTeacher, BaseFast_CCA_PreTrain)."""

from vmrframe_tpu_torch.models import actionformer, backbone, basefast, distill, seqpan  # noqa: F401
