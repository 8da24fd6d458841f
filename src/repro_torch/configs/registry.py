"""Architecture registry of the port: ``--arch`` id -> TransformerConfig.

The reference maps every id to a bundle (config, init, sharding rules,
step functions).  The port serves the dense LM ids; the others raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import importlib

from repro_torch.models.transformer import TransformerConfig

ARCH_IDS = [
    "minicpm-2b",
    "granite-3-2b",
    "qwen1.5-4b",
    "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b",
    "mace",
    "dlrm-mlperf",
    "din",
    "sasrec",
    "two-tower-retrieval",
]

_MODULES = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
}
SERVE_ARCH_IDS = list(_MODULES)

_NOT_PORTED = {
    "moonshot-v1-16b-a3b": "MoE LM: ROADMAP.md queue 1, item 10",
    "qwen3-moe-235b-a22b": "MoE LM: ROADMAP.md queue 1, item 10",
    "mace": "GNN: ROADMAP.md queue 1, item 11",
    "dlrm-mlperf": "recsys: ROADMAP.md queue 1, item 9",
    "din": "recsys: ROADMAP.md queue 1, item 9",
    "sasrec": "recsys: ROADMAP.md queue 1, item 9",
    "two-tower-retrieval": "recsys: ROADMAP.md queue 1, item 9",
}


def get_config(arch: str, reduced: bool = False) -> TransformerConfig:
    """The published (or, with ``reduced``, the smoke-size) configuration."""
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch} is not ported yet ({_NOT_PORTED[arch]})")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG
