"""Architecture registry of the port: importing this package registers every
ported architecture into ``configs.base.REGISTRY`` (today qwen3-1.7b; the
reference's other architectures wait for ROADMAP queue 1 item 9)."""

from repro_torch.configs.base import REGISTRY, ArchDef, all_arch_names, get_arch  # noqa: F401
from repro_torch.configs import qwen3_1_7b  # noqa: F401
