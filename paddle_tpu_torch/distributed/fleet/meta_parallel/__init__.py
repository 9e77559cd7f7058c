"""fleet.meta_parallel, the port of
`paddle_tpu/distributed/fleet/meta_parallel/`: the tensor-parallel and
pipeline layers and the `TensorParallel` / `PipelineParallel` wrappers
(the latter with the pipeline schedule over processes at pp > 1).
`ShardingParallel` is not ported (ROADMAP queue 1 item 2)."""
from .parallel_layers.mp_layers import (
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    ParallelCrossEntropy,
)
from .parallel_layers.pp_layers import (
    LayerDesc, SharedLayerDesc, SegmentLayers, PipelineLayer,
)
from .parallel_layers.random import (
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .tensor_parallel import TensorParallel
from .pipeline_parallel import PipelineParallel
