"""Distributed runtime helpers: straggler tracking.

The reference's ``distributed/sharding.py`` is ROADMAP queue 1 item 9 and
``distributed/elastic.py`` item 7.
"""

from repro_torch.distributed.straggler import StepTimer, StragglerReport  # noqa: F401
