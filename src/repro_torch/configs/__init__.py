"""LM configurations of the port: ``--arch <id>`` -> TransformerConfig."""

from repro_torch.configs.registry import ARCH_IDS, SERVE_ARCH_IDS, get_config  # noqa: F401
