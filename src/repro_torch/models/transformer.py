"""Decoder-only transformer: the serving entry points of
``repro.models.transformer`` (dense configurations).

GQA with optional QKV bias, RoPE, SwiGLU MLP, RMSNorm, tied or untied
unembedding.  ``prefill`` and ``decode_step`` keep the reference's bf16/f32
casts step for step; the layer ``scan`` is a Python loop.  Differences,
none of which changes a value:

  * parameters are held in ``cfg.dtype`` once (norm gains stay f32),
    where the reference keeps f32 masters and casts at every call;
  * the rotary tables are computed once per call, not per layer;
  * prefill attention runs through the flash kernel and decode attention
    through the paged kernel (``models.attention``);
  * the KV cache is head-major, (L, B, n_kv, S_max, D) — the reference's
    is (L, B, S_max, n_kv, D) — so each layer's cache is a page pool for
    the paged kernel; the cache dict also carries that view's ``page``
    and slot block ``table``;
  * ``decode_step`` writes the new token's K/V in place at
    ``[b, :, len[b]]`` and returns the same cache dict with ``len``
    advanced, where the reference selects with a one-hot mask over the
    whole cache and returns a new one.  A row whose length has reached
    S_max is left unwritten, as the reference's select leaves it.

A configuration with ``moe`` set raises ``NotImplementedError``: MoE
serving is ROADMAP.md queue 1, item 10.  ``backbone`` and ``lm_loss``
come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    attention,
    slot_block_table,
    slot_decode_attention,
    slot_page,
)
from repro_torch.models.moe import MoEConfig
from repro_torch.nn.layers import (
    apply_rope,
    dense_init,
    embedding_init,
    rms_norm,
    rope_tables,
)

Params = Dict[str, Any]

DEFAULT_PAGE = 16


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's configuration.  ``loss_chunk`` and ``flash_chunk``
    are carried so configs compare field for field; the training slice
    reads ``loss_chunk``, and nothing reads ``flash_chunk`` (the flash
    kernel has no chunk).  The reference's ``remat`` and ``att_shard``
    (training and sharding knobs) are left out."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16
    loss_chunk: int = 512
    flash_chunk: int = 1024

    @property
    def params_dense(self) -> int:
        """Total parameter count (all experts included)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        att = d * (self.n_heads * self.d_head) + 2 * d * (
            self.n_kv_heads * self.d_head
        ) + (self.n_heads * self.d_head) * d
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff
            ff += self.moe.n_shared_experts * 3 * d * self.moe.d_ff
            ff += d * self.moe.n_experts  # router
        else:
            ff = 3 * d * f
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (att + ff + 2 * d) + emb + d


def require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet "
            "(ROADMAP.md queue 1, item 10)"
        )


# ------------------------------------------------------------------- init ---
def init_params(cfg: TransformerConfig, gen: torch.Generator) -> Params:
    """Seeded random weights on ``gen``'s device, in the reference's
    structure and scales (``dense_init``, ``embedding_init``), matrices
    cast to ``cfg.dtype`` once."""
    require_dense(cfg)
    L, d = cfg.n_layers, cfg.d_model
    qd = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    dev = gen.device

    def stack(d_in, d_out, bias=False):
        layers = [dense_init(gen, d_in, d_out, bias=bias) for _ in range(L)]
        return {k: torch.stack([p[k] for p in layers]).to(cfg.dtype)
                for k in layers[0]}

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    params: Params = {
        "embed": {"table": embedding_init(gen, cfg.vocab, d)["table"].to(cfg.dtype)},
        "ln_f": ones(d),
        "block": {
            "ln1": ones(L, d),
            "ln2": ones(L, d),
            "wq": stack(d, qd, cfg.qkv_bias),
            "wk": stack(d, kvd, cfg.qkv_bias),
            "wv": stack(d, kvd, cfg.qkv_bias),
            "wo": stack(qd, d),
            "mlp": {"wg": stack(d, cfg.d_ff), "wu": stack(d, cfg.d_ff),
                    "wd": stack(cfg.d_ff, d)},
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {
            "w": dense_init(gen, d, cfg.vocab)["w"].to(cfg.dtype)}
    return params


def _layer(tree, i: int):
    """Layer ``i``'s slice of the stacked block parameters."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------- forward ---
def _qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor):
    q = h @ lp["wq"]["w"]
    k = h @ lp["wk"]["w"]
    v = h @ lp["wv"]["w"]
    if cfg.qkv_bias:
        q = q + lp["wq"]["b"]
        k = k + lp["wk"]["b"]
        v = v + lp["wv"]["b"]
    B, S, _ = h.shape
    return (q.reshape(B, S, cfg.n_heads, cfg.d_head),
            k.reshape(B, S, cfg.n_kv_heads, cfg.d_head),
            v.reshape(B, S, cfg.n_kv_heads, cfg.d_head))


def _mlp(cfg: TransformerConfig, lp: Params, xx: torch.Tensor) -> torch.Tensor:
    h = rms_norm(lp["ln2"], xx, cfg.rms_eps)
    m = lp["mlp"]
    g = F.silu(h @ m["wg"]["w"])
    u = h @ m["wu"]["w"]
    y = (g * u) @ m["wd"]["w"]
    return xx + y.to(xx.dtype)


def _unembed_chunk(cfg: TransformerConfig, params: Params,
                   h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].to(h.dtype).T
    return h @ params["unembed"]["w"].to(h.dtype)


# ------------------------------------------------------------------ serve ---
def make_cache(cfg: TransformerConfig, batch: int, s_max: int, dtype=None,
               page_size: int = DEFAULT_PAGE, device: DeviceLike = None) -> Dict:
    """An empty head-major cache: ``k``/``v`` (L, batch, n_kv, s_max, D),
    ``len`` (batch,) int32, and the pool view's ``page`` and slot
    ``table`` (see ``models.attention``)."""
    require_dense(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    L, n_kv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    page = slot_page(s_max, page_size)
    return {
        "k": torch.zeros((L, batch, n_kv, s_max, D), dtype=dtype, device=dev),
        "v": torch.zeros((L, batch, n_kv, s_max, D), dtype=dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "page": page,
        "table": slot_block_table(batch, n_kv, s_max, page, dev),
    }


def prefill(cfg: TransformerConfig, params: Params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    """Process a prompt; return last-position logits (B, vocab) and its
    head-major K/V (``k``, ``v``: (L, B, n_kv, S, D)) with ``len``, for
    copying into the slots of a :func:`make_cache` cache."""
    require_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"]["table"][tokens]
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["block"], i)
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
        q, k, v = _qkv(cfg, lp, h)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attention(q, k, v, causal=True)
        o = o.reshape(B, S, cfg.n_heads * cfg.d_head) @ lp["wo"]["w"]
        x = x + o.to(x.dtype)
        x = _mlp(cfg, lp, x)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    x = rms_norm(params["ln_f"], x, cfg.rms_eps)
    logits = _unembed_chunk(cfg, params, x[:, -1:, :])
    cache = {
        "k": torch.stack(ks),  # (L, B, n_kv, S, D)
        "v": torch.stack(vs),
        "len": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
    }
    return logits[:, 0], cache


def decode_step(cfg: TransformerConfig, params: Params, token: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token (B,) -> logits (B, vocab); the
    :func:`make_cache` cache is updated in place and returned with
    ``len`` advanced by one."""
    require_dense(cfg)
    B = token.shape[0]
    lens = cache["len"]  # (B,)
    positions = lens[:, None]  # (B, 1)
    x = params["embed"]["table"][token[:, None]]
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    s_max = cache["k"].shape[3]
    bidx = torch.arange(B, device=token.device)
    # the new token's K/V is written in place at [b, :, len[b]], where the
    # reference selects with a one-hot mask over the whole cache: the same
    # values.  A full row (len == S_max) rewrites its last entry with its
    # own value, i.e. stays unwritten, as under the reference's select.
    slot = lens.long().clamp(max=s_max - 1)
    room = (lens < s_max)[:, None, None]
    new_lens = lens + 1
    for i in range(cfg.n_layers):
        lp = _layer(params["block"], i)
        kc, vc = cache["k"][i], cache["v"][i]  # (B, n_kv, S_max, D) views
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
        q, k, v = _qkv(cfg, lp, h)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kc[bidx, :, slot] = torch.where(room, k[:, 0].to(kc.dtype),
                                        kc[bidx, :, slot])
        vc[bidx, :, slot] = torch.where(room, v[:, 0].to(vc.dtype),
                                        vc[bidx, :, slot])
        o = slot_decode_attention(q, kc, vc, new_lens, cache["page"],
                                  cache["table"])
        o = o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ lp["wo"]["w"]
        x = x + o.to(x.dtype)
        x = _mlp(cfg, lp, x)
    x = rms_norm(params["ln_f"], x, cfg.rms_eps)
    logits = _unembed_chunk(cfg, params, x)[:, 0]
    cache["len"] = new_lens
    return logits, cache
