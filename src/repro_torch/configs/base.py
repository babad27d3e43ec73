"""Architecture registry: each architecture registers an ``ArchDef`` with
its full and its smoke config. The reference's dry-run shape cells
(``ShapeCell``, ``CellBuild``) wait for ROADMAP queue 1 item 9."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: str                 # lm | gnn | recsys
    source: str                 # public-literature citation tag
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]


REGISTRY: dict = {}


def register(arch: ArchDef) -> ArchDef:
    REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> ArchDef:
    if name not in REGISTRY:
        import repro_torch.configs  # noqa: F401  (importing registers)
    if name not in REGISTRY:
        raise KeyError(f"unknown or unported architecture {name!r}; ported: {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_arch_names() -> list:
    import repro_torch.configs  # noqa: F401

    return sorted(REGISTRY)
