"""Architecture registry of the port: importing this package registers every
ported architecture (the five LMs and the paper's own APSS workload) into
``configs.base.REGISTRY``. The LMs' shape cells (``shapes={}`` until then)
and the recsys and GNN architectures wait for ROADMAP queue 1 items
9.4-9.8; ``get_arch`` of those raises ``KeyError``."""

from repro_torch.configs.base import (  # noqa: F401
    REGISTRY,
    ArchDef,
    CellBuild,
    ShapeCell,
    all_arch_names,
    get_arch,
)
from repro_torch.configs import (  # noqa: F401
    qwen3_1_7b,
    minicpm3_4b,
    qwen3_8b,
    arctic_480b,
    deepseek_moe_16b,
    apss_paper,
)

# The reference's assigned architectures (10), ported or not.
ASSIGNED = [
    "qwen3-1.7b",
    "minicpm3-4b",
    "qwen3-8b",
    "arctic-480b",
    "deepseek-moe-16b",
    "gat-cora",
    "two-tower-retrieval",
    "bert4rec",
    "din",
    "bst",
]
