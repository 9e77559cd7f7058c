"""paddle_tpu_torch.incubate.optimizer: the averaging wrappers, as the
JAX package's `incubate.optimizer` exports them."""
from ...optimizer.averaging import LookAhead, ModelAverage

__all__ = ["LookAhead", "ModelAverage"]
