"""Model zoo; importing it registers each model (SeqPAN so far)."""

from vmrframe_tpu_torch.models import seqpan  # noqa: F401
