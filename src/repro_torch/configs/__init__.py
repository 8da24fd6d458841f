"""Configurations of the port: ``--arch <id>`` -> LM, GNN or recsys config."""

from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    RECSYS_ARCH_IDS,
    SERVE_ARCH_IDS,
    family,
    get_config,
    get_serving,
    get_training,
)
