"""paddle_tpu_torch.incubate.nn — the fused transformer layers
(`layer`), the fused functional ops (`functional`: the fused LayerNorm
entry points and SDPA with its routing, `attention`), and the port's
hand-written kernels (`kernels`, counterpart of
paddle_tpu.incubate.nn.pallas)."""
from . import functional
from .layer import (FusedFeedForward, FusedMultiHeadAttention,
                    FusedTransformerEncoderLayer, set_use_kernel)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "functional", "set_use_kernel"]
