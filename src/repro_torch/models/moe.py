"""Mixture-of-experts configuration (a copy of ``repro.models.moe.MoEConfig``).

The MoE layer itself (router, dispatch, experts) is not ported yet
(ROADMAP.md queue 1, item 10): the port's transformer raises
``NotImplementedError`` for a configuration that sets ``moe``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared_experts: int = 0      # DeepSeek/Moonlight-style always-on experts
    capacity_factor: float = 1.25
    group_tokens: int = 4096       # tokens per dispatch group
    dispatch: str = "onehot"
