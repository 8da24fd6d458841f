"""Architecture registry of the port: ``--arch`` id -> config and bundle.

The reference maps every id to a bundle (config, init, sharding rules,
step functions).  So does the port, each bundle with its family's rules,
param and opt shardings and its cells' abstract inputs and input
shardings (``configs.families``): the LM ids, dense and MoE (``get_config``
gives their ``TransformerConfig``, ``get_bundle`` their
:class:`~repro_torch.configs.families.LMBundle`), the GNN id ``mace``
(its ``MACEConfig``, and a :class:`~repro_torch.configs.families.GNNBundle`
of four cells), and the recsys ids (``get_config`` gives their config,
``get_serving`` their score and retrieval functions and cell sizes,
``get_training`` their training cell, ``get_bundle`` both).  ``family``
tells the families apart as the reference's bundles do; ``shape_cells``
and ``all_cells`` list the reference's cells.
"""

from __future__ import annotations

import importlib

from typing import Any, List, Tuple, Union

from repro_torch.configs.families import (
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    REDUCED_LM_CELL_SHAPES,
    GNNBundle,
    LMBundle,
    RecsysBundle,
    RecsysServing,
    RecsysTraining,
    lm_bundle,
)

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
_MOE_MODULES = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
}
MOE_ARCH_IDS = list(_MOE_MODULES)
LM_ARCH_IDS = SERVE_ARCH_IDS + MOE_ARCH_IDS
_RECSYS_MODULES = {
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "din": "repro_torch.configs.din_cfg",
    "sasrec": "repro_torch.configs.sasrec_cfg",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
}
RECSYS_ARCH_IDS = list(_RECSYS_MODULES)

_GNN_MODULES = {"mace": "repro_torch.configs.mace_cfg"}


def family(arch: str) -> str:
    """``"lm"``, ``"gnn"`` or ``"recsys"``, the reference bundle's family."""
    if arch in _RECSYS_MODULES:
        return "recsys"
    if arch in _GNN_MODULES:
        return "gnn"
    if arch in ARCH_IDS:
        return "lm"
    raise KeyError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")


def _module(arch: str):
    name = (_MODULES.get(arch) or _MOE_MODULES.get(arch)
            or _RECSYS_MODULES.get(arch) or _GNN_MODULES.get(arch))
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


def get_bundle(arch: str, reduced: bool = False
               ) -> Union[LMBundle, RecsysBundle, GNNBundle]:
    """The arch's bundle: an LM arch's :class:`LMBundle` (the reference
    bundle's cell shapes, microbatches and optimizer), a recsys arch's
    :class:`RecsysBundle`, the GNN arch's :class:`GNNBundle`."""
    mod = _module(arch)
    if family(arch) == "gnn":
        return mod.bundle(reduced=reduced)
    if family(arch) == "recsys":
        return RecsysBundle(name=arch, serving=mod.serving(reduced=reduced),
                            training=mod.training(reduced=reduced))
    opt = getattr(mod, "OPT", None)
    if reduced:
        return lm_bundle(arch, mod.REDUCED, shapes=REDUCED_LM_CELL_SHAPES,
                         opt=opt)
    return lm_bundle(arch, mod.CONFIG, opt=opt, microbatches=mod.MICROBATCHES)


def shape_cells(arch: str) -> List[str]:
    """The arch's cells, in the reference's order (a GNN id's too)."""
    return list({"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                 "recsys": RECSYS_SHAPES}[family(arch)])


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in shape_cells(a)]
