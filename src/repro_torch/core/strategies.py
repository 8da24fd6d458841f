"""Strategy configuration for easily updatable index construction.

The paper (sections 5.1-5.9) defines nine composable strategies.  A
:class:`StrategyConfig` selects which are active and their parameters.
The three experiment sets of section 6.4 are provided as constructors.

Strategy roles (see DESIGN.md for the full table):
  C1   — always on: per-stream cluster cache + phase-wise key groups.
  EM   — posting lists below ``em_limit`` bytes live inside the dictionary.
  PART — lists below half a cluster live in 1/2^k sub-cluster "parts".
  S    — contiguous power-of-two segments, doubling up to ``seg_max``.
  FL   — first-level hot-append cluster area, bulk loaded/saved per phase.
  TAG  — many tiny keys share one tagged stream (dictionary level).
  CH   — backward-linked bounded chain of segments; converts to S at limit.
  SR   — short-record RAM accumulator (128-byte blocks), only full clusters
         enter chains; SR file streamed sequentially per phase.
  DS   — device-level small-write packing (PackedWriteDevice).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    # cluster geometry
    cluster_size: int = 32 * 1024

    # C1 cache (always active, paper 5.1)
    cache_clusters_per_stream: int = 45
    cache_total_bytes: int = 1 << 30  # 1 GB, paper Table 1

    # EM (5.2)
    use_em: bool = True
    em_limit: int = 64  # bytes of encoded postings kept in the dictionary

    # PART (5.3)
    use_part: bool = True
    part_max_splits: int = 4  # parts of cluster/2 .. cluster/2^4

    # S (5.4)
    seg_max: int = 8  # N: maximum segment length in clusters (power of two)

    # FL (5.5)
    use_fl: bool = True

    # TAG (5.6)
    use_tag: bool = True
    tag_bucket_keys: int = 32           # keys hashed into one tagged stream
    tag_extract_bytes: int = 8 * 1024   # extract a key once it owns this much

    # CH (5.7)
    use_ch: bool = False
    chain_limit: int = 9       # max chain length, counted in segments (5.7.3)
    chain_limit_jitter: int = 0  # optional [limit-jitter, limit] per-stream limit
    ch_min_merge_segments: int = 2  # 5.7.2: merge at least the two last segments

    # SR (5.8)
    use_sr: bool = False
    sr_block: int = 128
    sr_memory_limit: int = 64 << 20  # RAM budget for SR-records per phase

    # DS (5.9) — applied at the device level
    use_ds: bool = False
    ds_small_threshold: int = 32 * 1024  # paper Table 1: <= 32 KB is "small"
    ds_buffer_size: int = 1 << 20

    def with_overrides(self, **kw) -> "StrategyConfig":
        return dataclasses.replace(self, **kw)

    # --- the paper's three experiment sets (6.4) -------------------------------
    @staticmethod
    def set1(**kw) -> "StrategyConfig":
        """C1+EM+PART+S+FL+TAG."""
        return StrategyConfig(use_ch=False, use_sr=False, use_ds=False, **kw)

    @staticmethod
    def set2(**kw) -> "StrategyConfig":
        """set1 + CH + SR."""
        return StrategyConfig(use_ch=True, use_sr=True, use_ds=False, **kw)

    @staticmethod
    def set3(**kw) -> "StrategyConfig":
        """set2 + DS."""
        return StrategyConfig(use_ch=True, use_sr=True, use_ds=True, **kw)

    @property
    def cluster_capacity(self) -> int:
        """Payload capacity of a linked cluster."""
        from repro_torch.core.cluster_store import LINK_BYTES

        return self.cluster_size - LINK_BYTES

    def part_sizes(self) -> list:
        """Available PART sub-cluster sizes, smallest first (paper 5.3)."""
        return [self.cluster_size // (1 << k) for k in range(self.part_max_splits, 0, -1)]
