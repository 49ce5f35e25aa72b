"""Layer library (torch.nn), mirroring ``vmrframe_tpu/layers``."""

from vmrframe_tpu_torch.layers.attention import (  # noqa: F401
    CQAttention,
    CQConcatenate,
    DualAttentionBlock,
    DualMultiAttention,
    WeightedPool,
)
from vmrframe_tpu_torch.layers.basic import (  # noqa: F401
    CharacterEmbedding,
    Conv1D,
    DepthwiseConv1D,
    DepthwiseSeparableConvBlock,
    Embedding,
    FeatureEncoder,
    LayerNorm,
    PositionalEmbedding,
    VisualProjection,
    WordEmbedding,
)
from vmrframe_tpu_torch.layers.predictor import (  # noqa: F401
    FeatureEncoderPredict,
    SeqPANPredictor,
    TopSelfAttention,
)
