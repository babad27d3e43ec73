"""Distributed runtime helpers: the sharding context, elastic re-mesh and
straggler tracking."""

from repro_torch.distributed.sharding import (  # noqa: F401
    active_mesh,
    data_axes,
    model_axis,
    shard,
    shard_params,
    use_mesh,
)
from repro_torch.distributed.elastic import ElasticPlan, reshard_tree  # noqa: F401
from repro_torch.distributed.straggler import StepTimer, StragglerReport  # noqa: F401
