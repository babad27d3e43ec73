"""Distributed runtime helpers: elastic re-mesh and straggler tracking.

The reference's ``distributed/sharding.py`` is ROADMAP queue 1 item 9.4.
"""

from repro_torch.distributed.elastic import ElasticPlan, reshard_tree  # noqa: F401
from repro_torch.distributed.straggler import StepTimer, StragglerReport  # noqa: F401
