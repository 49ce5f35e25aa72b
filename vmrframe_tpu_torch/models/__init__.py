"""Model zoo; importing it registers each model (SeqPAN, ActionFormer)."""

from vmrframe_tpu_torch.models import actionformer, seqpan  # noqa: F401
