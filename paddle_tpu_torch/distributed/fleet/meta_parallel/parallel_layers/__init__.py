from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,
                        SharedLayerDesc)
from .random import (RNGStatesTracker, get_rng_state_tracker,
                     model_parallel_random_seed)
