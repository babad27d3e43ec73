"""Architecture registry of the port: importing this package registers every
assigned architecture (the five LMs, GAT and the four recsys models) and
the paper's own APSS workload into ``configs.base.REGISTRY``, each with the
reference's shape cells (``lm_common``, ``recsys_common``, ``gat_cora``,
``apss_paper``)."""

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
    gat_cora,
    two_tower_retrieval,
    bert4rec,
    din,
    bst,
    apss_paper,
)

# Assigned architectures (10) — importing registers them.
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
