"""Decoder-only transformer family (dense + MoE), the port of
``repro.models.transformer``: the serving entry points (``prefill``,
``decode_step``) and the training ones (``backbone``, ``lm_loss``).

GQA with optional QKV bias, RoPE, SwiGLU MLP or MoE FFN
(``models.moe``), RMSNorm, tied or untied unembedding.  Every entry point
keeps the reference's bf16/f32 casts step for step; the layer ``scan`` is
a Python loop.  Differences, none of which changes a value:

  * serving parameters are held in ``cfg.dtype`` once (norm gains and
    the MoE router stay f32), where the reference keeps f32 masters and
    casts at every call; training takes f32 masters
    (``init_params(..., masters=True)``) and casts at every use, as the
    reference does;
  * the rotary tables are computed once per call, not per layer;
  * attention runs through the flash kernel (prefill and training, the
    latter under its ``autograd.Function``) and decode attention through
    the paged kernel (``models.attention``);
  * the KV cache is head-major, (L, B, n_kv, S_max, D) — the reference's
    is (L, B, S_max, n_kv, D) — so each layer's cache is a page pool for
    the paged kernel; the cache dict also carries that view's ``page``
    and slot block ``table``;
  * ``decode_step`` writes the new token's K/V in place at
    ``[b, :, len[b]]`` and returns the same cache dict with ``len``
    advanced, where the reference selects with a one-hot mask over the
    whole cache and returns a new one.  A row whose length has reached
    S_max is left unwritten, as the reference's select leaves it;
  * inside a model group (``distributed.tensor_parallel``) every entry
    point computes on the weights' ``model`` shards (:class:`LMPlan`),
    where the reference's GSPMD program computes on them under
    ``LM_RULES``; ``decode_step`` then takes the cache as the reference's
    decode cells lay it out, its sequence split over ``model``, and
    merges the ranks' attention by their log-sum-exp;
  * ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``) under both of the reference's policies,
    and ``lm_loss`` recomputes each loss chunk's logits: memory, not
    values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.hooks import (
    BatchAxes,
    batch_axes,
    batch_mean,
    batch_pmean,
    batch_ranks,
    constrain,
    local,
)
from repro_torch.distributed.tensor_parallel import (
    ModelGroup,
    copy_to_model,
    gather_from_model,
    merge_attention_partials,
    model_group,
    reduce_from_model,
    vocab_parallel_xent,
)
from repro_torch.models.attention import (
    attention,
    slot_block_table,
    slot_decode_attention,
    slot_page,
)
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init
from repro_torch.nn.layers import (
    apply_rope,
    dense_init,
    embedding_init,
    rms_norm,
    rope_tables,
    softmax_xent,
)
from repro_torch.obs import span
from repro_torch.tree import (
    flatten_with_path,
    leaves,
    path_name,
    tree_map,
    unflatten,
)

Params = Dict[str, Any]

DEFAULT_PAGE = 16
AUX_SUMS = ("dropped_tokens", "balance_loss")   # MoE aux values, per layer


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's configuration.  ``flash_chunk`` is carried so
    configs compare field for field; nothing reads it (the flash kernel
    has no chunk).  ``att_shard`` ("heads", "seq" or "none") is carried
    for the same comparison: it picks the attention activations'
    ``constrain``, as in the reference.  Those calls are no-ops on the
    local tensors the port computes on; a train step on a mesh splits
    the heads over ``model`` itself (:class:`LMPlan`), which is where
    "heads" places them."""

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
    remat: str = "dots"          # none | dots | full
    loss_chunk: int = 512
    flash_chunk: int = 1024
    att_shard: str = "heads"     # heads | seq | none

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

    @property
    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.params_dense
        d, L = self.d_model, self.n_layers
        att = d * (self.n_heads * self.d_head) + 2 * d * (
            self.n_kv_heads * self.d_head
        ) + (self.n_heads * self.d_head) * d
        ff = (self.moe.top_k + self.moe.n_shared_experts) * 3 * d * self.moe.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * (att + ff + 2 * d) + emb + d


# ------------------------------------------------------------------- init ---
def _stacked(L: int, make) -> Params:
    """The layers of ``make()`` (a tree of one layer's tensors, drawn on
    each call) stacked along a new first axis, drawn one layer at a time
    into preallocated tensors: no stacked f32 copy of a whole weight ever
    exists (Moonshot's experts alone would be 35 GB of it)."""
    out = None
    for i in range(L):
        layer = make()
        if out is None:
            out = tree_map(lambda t: torch.empty((L,) + tuple(t.shape),
                                                 dtype=t.dtype,
                                                 device=t.device), layer)
        for dst, src in zip(leaves(out), leaves(layer)):
            dst[i].copy_(src)
        del layer
    return out


def init_params(cfg: TransformerConfig, gen: torch.Generator,
                masters: bool = False) -> Params:
    """Seeded random weights on ``gen``'s device, in the reference's
    structure and scales (``dense_init``, ``embedding_init``,
    ``moe_init``).  Matrices are held in ``cfg.dtype`` (serving), or in
    f32 with ``masters`` (training, the reference's own layout); norm
    gains and the MoE router are f32 either way."""
    L, d = cfg.n_layers, cfg.d_model
    qd = cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    dev = gen.device
    wdt = torch.float32 if masters else cfg.dtype

    def stack(d_in, d_out, bias=False):
        return _stacked(L, lambda: {
            k: v.to(wdt) for k, v in dense_init(gen, d_in, d_out,
                                                bias=bias).items()})

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    # drawn in the order of earlier releases (embedding, then the block,
    # then the unembedding), so a seed gives the same dense weights
    embed = {"table": embedding_init(gen, cfg.vocab, d)["table"].to(wdt)}
    block: Params = {
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "wq": stack(d, qd, cfg.qkv_bias),
        "wk": stack(d, kvd, cfg.qkv_bias),
        "wv": stack(d, kvd, cfg.qkv_bias),
        "wo": stack(qd, d),
    }
    if cfg.moe is not None:
        block["moe"] = _stacked(L, lambda: moe_init(gen, d, cfg.moe, wdt))
    else:
        block["mlp"] = {"wg": stack(d, cfg.d_ff), "wu": stack(d, cfg.d_ff),
                        "wd": stack(cfg.d_ff, d)}
    params: Params = {"embed": embed, "ln_f": ones(d), "block": block}
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": dense_init(gen, d, cfg.vocab)["w"].to(wdt)}
    return params


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of the stacked block parameters, each leaf split
    by one ``unbind``.  Under autograd, a layer taken by indexing the
    stack sends back a gradient the size of the whole stack for every
    layer, L times the stack's bytes in fills and adds a backward pass;
    ``unbind``'s backward stacks the L gradients once."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


# ------------------------------------------------- the split over model ---
@dataclasses.dataclass(frozen=True)
class LMPlan:
    """Which dimensions of an LM this rank computes on its ``model``
    shard (True) or whole (False): the Megatron column and row splits
    that GSPMD makes of the reference's LM under ``LM_RULES``, their
    collectives in ``distributed.tensor_parallel``.

      * attention: this rank's query heads (``wq``/``wk``/``wv``
        columns), ``wo``'s matching rows, the output summed over
        ``model``; K/V whole where ``model`` does not divide their heads,
        each rank taking the K/V head of its own query heads' group;
      * the MLP: ``wg``/``wu`` columns, ``wd`` rows, the output summed;
      * MoE: this rank's experts, dispatched into from the whole routing
        and combined partially; the shared experts split as the MLP; one
        sum;
      * the vocabulary: the embedding's rows (ids out of range look up
        zeros, then a sum) and the unembedding's columns, whose logits go
        through ``tensor_parallel.vocab_parallel_xent``."""
    group: ModelGroup
    heads: bool      # query heads (and wo's rows)
    kv: bool         # K/V heads
    mlp: bool        # the dense MLP's hidden
    experts: bool    # MoE experts
    shared: bool     # MoE shared experts' hidden
    vocab: bool      # embedding rows, unembedding columns

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    def part(self, n: int) -> slice:
        """This rank's block of ``n`` split ``size`` ways."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def plan_for(cfg: TransformerConfig, mg: ModelGroup) -> LMPlan:
    """The split of ``cfg`` over ``mg``: a dimension is split where
    ``mg.size`` divides its count of heads, hidden units, experts or
    vocabulary rows (``LM_RULES`` then shard it whole units a rank); K/V
    only where the query heads are, and the query heads under whole K/V
    only where each rank's fall in one K/V group.  Any other dimension
    is computed whole."""
    m = mg.size
    moe = cfg.moe
    kv = cfg.n_kv_heads % m == 0
    G = cfg.n_heads // cfg.n_kv_heads
    heads = cfg.n_heads % m == 0 and (kv or G % (cfg.n_heads // m) == 0)
    return LMPlan(
        group=mg,
        heads=heads,
        kv=heads and kv,
        mlp=moe is None and cfg.d_ff % m == 0,
        experts=moe is not None and moe.n_experts % m == 0,
        shared=(moe is not None and moe.n_shared_experts > 0
                and (moe.d_ff * moe.n_shared_experts) % m == 0),
        vocab=cfg.vocab % m == 0)


def lm_plan(cfg: TransformerConfig) -> Optional[LMPlan]:
    """The active model group's plan for ``cfg``; None outside one.  Model
    code asks once a forward, outside any recomputed part (a recomputed
    block runs again in the backward pass, which on the card runs on
    autograd's own thread, where the context is not set), and passes the
    plan down."""
    mg = model_group()
    return None if mg is None else plan_for(cfg, mg)


# the plan entry that splits each leaf, and the dimension (from the
# right) it splits
_LM_LEAVES = {
    "embed/table": ("vocab", -2),
    "unembed/w": ("vocab", -1),
    "block/wq/w": ("heads", -1), "block/wq/b": ("heads", -1),
    "block/wk/w": ("kv", -1), "block/wk/b": ("kv", -1),
    "block/wv/w": ("kv", -1), "block/wv/b": ("kv", -1),
    "block/wo/w": ("heads", -2),
    "block/mlp/wg/w": ("mlp", -1), "block/mlp/wu/w": ("mlp", -1),
    "block/mlp/wd/w": ("mlp", -2),
    "block/moe/wg": ("experts", -3), "block/moe/wu": ("experts", -3),
    "block/moe/wd": ("experts", -3),
    "block/moe/shared/wg": ("shared", -1),
    "block/moe/shared/wu": ("shared", -1),
    "block/moe/shared/wd": ("shared", -2),
}


def lm_model_dims(cfg: TransformerConfig, params: Params, mg: ModelGroup
                  ) -> Any:
    """A tree like ``params``: the dimension of each leaf that the plan
    keeps as this rank's ``model`` shard, or None for a leaf computed
    whole (the router, the norms, and any dimension the plan does not
    split)."""
    plan = plan_for(cfg, mg)
    out = []
    for path, leaf in flatten_with_path(params):
        entry = _LM_LEAVES.get(path_name(path))
        split = entry is not None and getattr(plan, entry[0])
        out.append(leaf.dim() + entry[1] if split else None)
    return unflatten(params, out)


# ---------------------------------------------------------------- forward ---
def _embed(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
           plan: Optional[LMPlan] = None) -> torch.Tensor:
    """The tokens' rows of the table in ``cfg.dtype`` (gathered, then cast:
    the reference's cast-then-gather, without casting the whole table).
    Where ``plan`` splits the vocabulary, the table is this rank's block
    of rows: ids outside it look up zeros and the rows are summed over
    ``model``."""
    table = params["embed"]["table"]
    if plan is None or not plan.vocab:
        return _cast(table[tokens], cfg.dtype)
    n = table.shape[0]
    at = tokens.long() - plan.rank * n
    here = ((at >= 0) & (at < n))[..., None]
    rows = torch.where(here, table[at.clamp(0, n - 1)], 0.0)
    return _cast(reduce_from_model(rows, plan.group), cfg.dtype)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A master weight (or its rows) in the compute dtype, in the span
    that every such cast is charged to."""
    with span("lm.cast"):
        return t.to(dtype)


def _constrain_qkv(cfg: TransformerConfig, q, k, v):
    """Attention activation sharding, as the reference's: heads on the
    model axis (K/V are constrained inside the attention ops)."""
    if cfg.att_shard in ("heads", "seq"):
        q = constrain(q, "batch", None, "model", None)
    return q, k, v


def _own_kv_head(cfg: TransformerConfig, plan: LMPlan) -> int:
    """The K/V head that this rank's query heads read, where the query
    heads are split over ``model`` and K/V are not: :func:`plan_for`
    splits them so only where a rank's heads fall in one group."""
    G = cfg.n_heads // cfg.n_kv_heads
    return plan.rank * (cfg.n_heads // plan.size) // G


def _qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         plan: Optional[LMPlan] = None):
    """Q, K and V (B, S, heads, D).  Where ``plan`` splits the heads,
    this rank's: ``wq``'s columns (and ``wk``'s, ``wv``'s where K/V
    split too) are its shards; whole K/V weights give the columns of
    :func:`_own_kv_head`, and their gradient is summed over ``model``."""
    dt = cfg.dtype
    h = h.to(dt)
    nq, nkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cols = None
    if plan is not None and plan.heads:
        h = copy_to_model(h, plan.group)
        nq //= plan.size
        if plan.kv:
            nkv //= plan.size
        else:
            nkv = 1
            cols = (_own_kv_head(cfg, plan) * D
                    + torch.arange(D, device=h.device))

    def weight(name: str, key: str) -> torch.Tensor:
        t = lp[name][key]
        if cols is not None and name != "wq":
            t = copy_to_model(t, plan.group).index_select(-1, cols)
        return _cast(t, dt)

    q = h @ weight("wq", "w")
    k = h @ weight("wk", "w")
    v = h @ weight("wv", "w")
    if cfg.qkv_bias:
        q = q + weight("wq", "b")
        k = k + weight("wk", "b")
        v = v + weight("wv", "b")
    B, S, _ = h.shape
    return (q.reshape(B, S, nq, D), k.reshape(B, S, nkv, D),
            v.reshape(B, S, nkv, D))


def _out(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
         o: torch.Tensor, plan: Optional[LMPlan] = None) -> torch.Tensor:
    """The residual ``x`` plus the attention output ``o`` (B, S, H, D)
    projected by ``wo`` (this rank's heads' rows under a ``plan`` that
    splits them, the products summed over ``model``)."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1) @ _cast(lp["wo"]["w"], cfg.dtype)
    if plan is not None and plan.heads:
        o = reduce_from_model(o, plan.group)
    return constrain(x + o.to(x.dtype), "batch", None, None)


def _attend(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
            cos: torch.Tensor, sin: torch.Tensor,
            plan: Optional[LMPlan] = None):
    """Causal self-attention over ``x`` (B, S, d) added to it, and the
    layer's roped K and its V, (B, S, n_kv, D) each (this rank's heads
    under ``plan``)."""
    with span("lm.norm"):
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
    q, k, v = _qkv(cfg, lp, h, plan)
    with span("lm.rope"):
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q, k, v = _constrain_qkv(cfg, q, k, v)
    return _out(cfg, lp, x, attention(q, k, v, causal=True), plan), k, v


def _ffn(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
         batch: Optional[BatchAxes] = None, plan: Optional[LMPlan] = None
         ) -> Tuple[torch.Tensor, Dict]:
    """``x`` plus its SwiGLU MLP or MoE layer, and the MoE's aux values
    (empty for a dense layer); ``batch`` and ``plan`` as ``moe_apply``
    takes them (the MLP's hidden units split under ``plan``, its output
    summed over ``model``)."""
    with span("lm.norm"):
        h = rms_norm(lp["ln2"], x, cfg.rms_eps)
    dt = cfg.dtype
    if cfg.moe is not None:
        y, aux = moe_apply(lp["moe"], h, cfg.moe, dtype=dt, batch=batch,
                           plan=plan)
    else:
        m = lp["mlp"]
        split = plan is not None and plan.mlp
        h = h.to(dt)
        if split:
            h = copy_to_model(h, plan.group)
        g = F.silu(h @ _cast(m["wg"]["w"], dt))
        u = h @ _cast(m["wu"]["w"], dt)
        y = (g * u) @ _cast(m["wd"]["w"], dt)
        if split:
            y = reduce_from_model(y, plan.group)
        aux = {}
    return x + y.to(x.dtype), aux


def _block_fwd(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor,
               batch: Optional[BatchAxes] = None,
               plan: Optional[LMPlan] = None) -> Tuple[torch.Tensor, Dict]:
    """One block: attention then the MLP or MoE, with the aux values."""
    x, _, _ = _attend(cfg, lp, x, cos, sin, plan)
    return _ffn(cfg, lp, x, batch, plan)


def _remat(cfg: TransformerConfig, fn):
    """``fn`` recomputed in the backward pass, per block.  The reference's
    ``"dots"`` policy saves the matmul outputs and ``"full"`` saves
    nothing; both are full per-block recompute here
    (``torch.utils.checkpoint``, non-reentrant).  That changes memory and
    time, not the function or its gradient."""
    if cfg.remat == "none":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def backbone(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
             positions: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict]:
    """Embed + all blocks + final norm.  Returns (B, S, d) hidden and
    the aux values summed over layers (MoE: ``dropped_tokens``,
    ``balance_loss``).

    Where the active mesh's batch axes split the batch over more than one
    rank, the MoE groups are cut as from the global batch and each
    layer's ``balance_loss`` is the global batch's, from the means of its
    factors over the ranks (``hooks.batch_pmean``, outside the
    recomputed block); ``dropped_tokens`` stays this rank's.

    Inside a model group (``distributed.tensor_parallel``), the block
    and embedding weights are this rank's ``model`` shards as
    :func:`lm_plan` splits them, and the hidden state is whole on every
    rank."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    # the mesh's axes are taken here, once: a recomputed block runs
    # where the mesh context is not set
    plan, axes = lm_plan(cfg), batch_axes()
    x = constrain(_embed(cfg, params, tokens, plan), "batch", None, None)
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    body = _remat(cfg, lambda lp, xx: _block_fwd(cfg, lp, xx, cos, sin,
                                                 axes, plan))
    sums: Dict = {}
    for lp in _unstack(params["block"], cfg.n_layers):
        x, aux = body(lp, x)
        if axes is not None and "gate_mean" in aux:
            aux["balance_loss"] = cfg.moe.n_experts * torch.sum(
                batch_pmean(aux["gate_mean"]) * batch_pmean(aux["route_frac"]))
        for key in AUX_SUMS:
            if key in aux:
                sums[key] = sums[key] + aux[key] if key in sums else aux[key]
    with span("lm.norm"):
        return rms_norm(params["ln_f"], x, cfg.rms_eps), sums


def _unembed_w(cfg: TransformerConfig, params: Params,
               dtype: torch.dtype) -> torch.Tensor:
    """The (d, vocab) unembedding in ``dtype``."""
    if cfg.tie_embeddings:
        return _cast(params["embed"]["table"], dtype).T
    return _cast(params["unembed"]["w"], dtype)


def _unembed_chunk(cfg: TransformerConfig, params: Params,
                   h: torch.Tensor) -> torch.Tensor:
    return h @ _unembed_w(cfg, params, h.dtype)


def _whole_logits(logits: torch.Tensor, plan: Optional[LMPlan]
                  ) -> torch.Tensor:
    """Logits over the whole vocabulary: under a ``plan`` that splits it,
    every rank's columns gathered over ``model`` in rank (= vocabulary)
    order."""
    if plan is None or not plan.vocab:
        return logits
    return gather_from_model(logits, plan.group)


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               plan: Optional[LMPlan] = None) -> torch.Tensor:
    """A chunk's mean cross-entropy; under a ``plan`` that splits the
    vocabulary, over this rank's columns (``vocab_parallel_xent``)."""
    logits = constrain(h @ w, "batch", None, "model")
    if plan is None or not plan.vocab:
        return softmax_xent(logits, labels)
    return vocab_parallel_xent(logits, labels, plan.rank * w.shape[-1],
                               plan.group)


def lm_loss(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Chunked-softmax LM loss: the logits of ``loss_chunk`` positions at
    a time, each chunk recomputed in the backward pass, so (B, S, vocab)
    is never materialized.  MoE configs add ``0.01 * balance_loss /
    n_layers``.

    Given DTensor tokens and labels (a step on a mesh), it takes this
    rank's rows and returns its share of the global loss
    (``hooks.batch_mean``); every rank holds the global balance term
    (``backbone``), so its share is that over the count of batch
    ranks.  Where a model group splits the vocabulary, each chunk's
    logits are this rank's columns and its loss the vocab-parallel
    cross-entropy."""
    tokens, labels = local(tokens), local(labels)
    h, aux = backbone(cfg, params, tokens)
    B, S, d = h.shape
    C = min(cfg.loss_chunk, S)
    assert S % C == 0
    with span("lm.loss"):
        w = _unembed_w(cfg, params, h.dtype)
        plan = lm_plan(cfg)
        if plan is not None and plan.vocab:
            h = copy_to_model(h, plan.group)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        n = torch.zeros((), dtype=torch.int64, device=h.device)
        for i in range(0, S, C):
            ll = labels[:, i:i + C]
            nll = checkpoint(_chunk_nll, h[:, i:i + C], w, ll, plan,
                             use_reentrant=False)
            cnt = (ll != -1).sum()
            tot = tot + nll * cnt
            n = n + cnt
        loss = batch_mean(tot, n)
        if "balance_loss" in aux:
            loss = loss + (0.01 * aux["balance_loss"] / cfg.n_layers
                           / batch_ranks())
        return loss, aux


class LMLoss:
    """``lm_loss`` of ``batch["tokens"]`` against ``batch["labels"]`` as
    a train step's ``loss(params, batch)``.  It declares the LM's split
    over a mesh's ``model`` axis (:meth:`model_dims`), so a step on a
    mesh computes on the weights' ``model`` shards; and it sums the MoE
    ``dropped_tokens`` of its calls (this rank's) into one 0-d tensor,
    ``dropped``, which :meth:`take_dropped` reads and clears."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg
        self.dropped: Optional[torch.Tensor] = None

    def __call__(self, params: Params, batch: Dict) -> torch.Tensor:
        loss, aux = lm_loss(self.cfg, params, batch["tokens"],
                            batch["labels"])
        if "dropped_tokens" in aux:
            d = aux["dropped_tokens"].detach()
            self.dropped = d if self.dropped is None else self.dropped + d
        return loss

    def take_dropped(self) -> float:
        """The tokens dropped since the last call (0 for a dense LM)."""
        d, self.dropped = self.dropped, None
        return 0.0 if d is None else float(d)

    def model_dims(self, params: Params, mg: ModelGroup) -> Any:
        """Each leaf's dimension kept as this rank's ``model`` shard, or
        None (:func:`lm_model_dims`)."""
        return lm_model_dims(self.cfg, params, mg)


# ------------------------------------------------------------------ serve ---
def make_cache(cfg: TransformerConfig, batch: int, s_max: int, dtype=None,
               page_size: int = DEFAULT_PAGE, device: DeviceLike = None) -> Dict:
    """An empty head-major cache: ``k``/``v`` (L, batch, n_kv, s_max, D),
    ``len`` (batch,) int32, and the pool view's ``page`` and slot
    ``table`` (see ``models.attention``)."""
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
    copying into the slots of a :func:`make_cache` cache.  For an MoE
    config the dict also holds ``moe_dropped``, the picks dropped by
    capacity over all layers (an f32 0-d tensor).

    Inside a model group the weights are this rank's ``model`` shards as
    :func:`lm_plan` splits them (as :func:`backbone` computes): the K/V
    returned are those of this rank's query heads, and the logits are
    whole, gathered over ``model`` where the vocabulary is split.  On a
    mesh whose batch axes split the batch, the MoE groups are cut as
    from the global batch (``moe_apply``'s ``batch``)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    plan, axes = lm_plan(cfg), batch_axes()
    x = _embed(cfg, params, tokens, plan)
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    ks, vs = [], []
    dropped = None
    for lp in _unstack(params["block"], cfg.n_layers):
        x, k, v = _attend(cfg, lp, x, cos, sin, plan)
        x, aux = _ffn(cfg, lp, x, axes, plan)
        dropped = _add_dropped(dropped, aux)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    x = rms_norm(params["ln_f"], x, cfg.rms_eps)
    logits = _whole_logits(_unembed_chunk(cfg, params, x[:, -1:, :]), plan)
    cache = {
        "k": torch.stack(ks),  # (L, B, n_kv, S, D)
        "v": torch.stack(vs),
        "len": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
    }
    if dropped is not None:
        cache["moe_dropped"] = dropped
    return logits[:, 0], cache


def _add_dropped(total: Optional[torch.Tensor], aux: Dict):
    if "dropped_tokens" not in aux:
        return total
    return aux["dropped_tokens"] if total is None else total + aux["dropped_tokens"]


def _decode_qkv(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
                plan: Optional[LMPlan] = None):
    """Q, K and V of the new token, (B, 1, heads, D), every head on every
    rank: a decode cache split over ``model`` on its sequence holds every
    head of its block.  Where ``plan`` splits the heads, each rank's
    (:func:`_qkv`) are gathered over ``model`` in one collective; where
    K/V are whole there, rank ``n * size // n_kv`` holds K/V head ``n``
    (:func:`_own_kv_head`)."""
    q, k, v = _qkv(cfg, lp, h, plan)
    if plan is None or not plan.heads:
        return q, k, v
    B, S, nq, D = q.shape
    nkv = k.shape[2]
    mine = torch.cat([t.reshape(B, S, -1) for t in (q, k, v)], -1)
    every = gather_from_model(mine, plan.group).reshape(
        B, S, plan.size, nq + 2 * nkv, D)
    q, k, v = (every[..., a:b, :].reshape(B, S, -1, D) for a, b in (
        (0, nq), (nq, nq + nkv), (nq + nkv, nq + 2 * nkv)))
    if not plan.kv:
        step = plan.size // cfg.n_kv_heads
        k, v = k[:, :, ::step], v[:, :, ::step]
    return q, k, v


def decode_step(cfg: TransformerConfig, params: Params, token: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token (B,) -> logits (B, vocab); the
    :func:`make_cache` cache is updated in place and returned with
    ``len`` advanced by one.  Every row takes part, the empty slots of an
    engine too (they carry token 0): with MoE they take expert capacity,
    as in the reference.  For an MoE config the cache's ``moe_dropped``
    is set to this step's picks dropped by capacity.

    Inside a model group the weights are this rank's ``model`` shards
    (:func:`lm_plan`) and the cache is this rank's block of the
    sequence, as the reference's decode cells lay it out (``P(None,
    batch, "model", None, None)``): ``k``/``v`` (L, B, n_kv, S_loc, D)
    hold positions ``rank * S_loc`` on of every row and head of an
    ``S_loc * size`` cache, ``page`` and ``table`` are made for S_loc,
    and ``len`` is the rows' whole length.  Per layer, Q, K and V of
    every head are on every rank (:func:`_decode_qkv`); the new entry is
    written by the rank whose block holds position ``len[b]``; each rank
    attends over its block's tokens with the paged kernel, which returns
    the log-sum-exp too, and the ranks' outputs merge over ``model``
    (``tensor_parallel.merge_attention_partials``: reduce-scattered into
    ``wo``'s row split where the plan splits the heads, all-reduced
    where it does not).  MoE groups are cut as from the global batch on
    a mesh whose batch axes split it.  The logits are whole."""
    B = token.shape[0]
    plan, axes = lm_plan(cfg), batch_axes()
    lens = cache["len"]  # (B,)
    positions = lens[:, None]  # (B, 1)
    x = _embed(cfg, params, token[:, None], plan)
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    s_loc = cache["k"].shape[3]
    start = 0 if plan is None else plan.rank * s_loc
    bidx = torch.arange(B, device=token.device)
    # the new token's K/V is written in place at [b, :, len[b]], where the
    # reference selects with a one-hot mask over the whole cache: the same
    # values.  Only the block that holds position len[b] writes it; a full
    # row (len == S_max) lies in none and stays unwritten (its last entry
    # rewritten with its own value), as under the reference's select.
    at = lens.long() - start
    room = ((at >= 0) & (at < s_loc))[:, None, None]
    slot = at.clamp(0, s_loc - 1)
    new_lens = lens + 1
    # the tokens of each row in this block
    block_lens = (new_lens - start).clamp(0, s_loc)
    dropped = None
    layers = _unstack(params["block"], cfg.n_layers)
    for lp, kc, vc in zip(layers, cache["k"], cache["v"]):
        # kc, vc: (B, n_kv, S_loc, D) views of the layer's cache
        h = rms_norm(lp["ln1"], x, cfg.rms_eps)
        q, k, v = _decode_qkv(cfg, lp, h, plan)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        q, k, v = _constrain_qkv(cfg, q, k, v)
        kc[bidx, :, slot] = torch.where(room, k[:, 0].to(kc.dtype),
                                        kc[bidx, :, slot])
        vc[bidx, :, slot] = torch.where(room, v[:, 0].to(vc.dtype),
                                        vc[bidx, :, slot])
        if plan is None:
            o = slot_decode_attention(q, kc, vc, block_lens, cache["page"],
                                      cache["table"])
        else:
            o, lse = slot_decode_attention(q, kc, vc, block_lens,
                                           cache["page"], cache["table"],
                                           return_lse=True)
            o = merge_attention_partials(o[:, 0], lse, plan.group,
                                         heads=plan.heads
                                         ).to(o.dtype)[:, None]
        x = _out(cfg, lp, x, o, plan)
        x, aux = _ffn(cfg, lp, x, axes, plan)
        dropped = _add_dropped(dropped, aux)
    x = rms_norm(params["ln_f"], x, cfg.rms_eps)
    logits = _whole_logits(_unembed_chunk(cfg, params, x)[:, 0], plan)
    cache["len"] = new_lens
    if dropped is not None:
        cache["moe_dropped"] = dropped
    return logits, cache
