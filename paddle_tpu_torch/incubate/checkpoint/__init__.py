"""paddle_tpu_torch.incubate.checkpoint: `elastic.CheckpointManager`
(training-state snapshots under `hapi.Model.fit(resume=...)`) and
`auto_checkpoint` (epoch ranges over registered state dicts)."""
from . import auto_checkpoint, elastic
from .elastic import CheckpointManager

__all__ = ["auto_checkpoint", "elastic", "CheckpointManager"]
