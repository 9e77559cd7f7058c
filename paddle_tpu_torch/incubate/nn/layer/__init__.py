"""paddle_tpu_torch.incubate.nn.layer — the fused transformer layers."""
from .fused_transformer import (FusedFeedForward, FusedMultiHeadAttention,
                                FusedTransformerEncoderLayer, set_use_kernel)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "set_use_kernel"]
