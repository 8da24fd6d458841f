"""Architecture registry of the port: ``--arch`` id -> config.

The reference maps every id to a bundle (config, init, sharding rules,
step functions).  The port serves the dense LM ids (``get_config`` gives
their ``TransformerConfig``) and the recsys ids (``get_config`` gives
their config, ``get_serving`` their score and retrieval functions and
cell sizes, ``get_training`` their training cell); MoE and GNN ids raise
``NotImplementedError`` naming the
ROADMAP.md item that ports them.  ``family`` tells the families apart
as the reference's bundles do.
"""

from __future__ import annotations

import importlib

from typing import Any

from repro_torch.configs.families import RecsysServing, RecsysTraining

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
SERVE_ARCH_IDS = list(_MODULES)   # the dense LM ids
_RECSYS_MODULES = {
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "din": "repro_torch.configs.din_cfg",
    "sasrec": "repro_torch.configs.sasrec_cfg",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
}
RECSYS_ARCH_IDS = list(_RECSYS_MODULES)

_NOT_PORTED = {
    "moonshot-v1-16b-a3b": "MoE LM: ROADMAP.md queue 1, item 10",
    "qwen3-moe-235b-a22b": "MoE LM: ROADMAP.md queue 1, item 10",
    "mace": "GNN: ROADMAP.md queue 1, item 11",
}


def family(arch: str) -> str:
    """``"lm"``, ``"gnn"`` or ``"recsys"``, the reference bundle's family."""
    if arch in _RECSYS_MODULES:
        return "recsys"
    if arch == "mace":
        return "gnn"
    if arch in ARCH_IDS:
        return "lm"
    raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"{arch} is not ported yet ({_NOT_PORTED[arch]})")
    name = _MODULES.get(arch) or _RECSYS_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    return importlib.import_module(name)


def get_config(arch: str, reduced: bool = False) -> Any:
    """The published (or, with ``reduced``, the smoke-size) configuration."""
    mod = _module(arch)
    return mod.REDUCED if reduced else mod.CONFIG


def get_serving(arch: str, reduced: bool = False) -> RecsysServing:
    """A recsys arch's config, entry points and cell sizes."""
    if family(arch) != "recsys":
        raise ValueError(f"{arch} is not a recsys arch")
    return _module(arch).serving(reduced=reduced)


def get_training(arch: str, reduced: bool = False) -> RecsysTraining:
    """A recsys arch's ``train_batch`` cell: loss, batch size, optimizer
    and train step."""
    if family(arch) != "recsys":
        raise ValueError(f"{arch} is not a recsys arch")
    return _module(arch).training(reduced=reduced)
