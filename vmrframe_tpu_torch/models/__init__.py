"""Model zoo; importing it registers each model (SeqPAN, BackBone, BaseFast,
ActionFormer)."""

from vmrframe_tpu_torch.models import actionformer, backbone, basefast, seqpan  # noqa: F401
