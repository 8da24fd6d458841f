"""RecSys serving, the port of ``repro.models.recsys``: DLRM (MLPerf),
DIN, SASRec and two-tower retrieval.

Entry points per arch, each taking the reference's batch dicts (tensors
in place of arrays):

  * ``*_init(cfg, gen, masters=False)`` — parameters from a
                                       ``torch.Generator``
  * ``*_loss(cfg, p, batch)``        — training objective
  * score (``dlrm_forward``, ``din_forward``, ``sasrec_score``,
    ``twotower_score``)              — pointwise serving (p99 / bulk)
  * ``*_retrieval(cfg, p, batch)``   — one query against N candidates,
    the ids of the top 100, from ``*_candidate_scores``

Serving parameters are held in ``cfg.dtype`` once (SASRec's norm gains
stay f32): at DLRM-MLPerf's widths the 26 tables are 45.5 GB in bf16 and
would not fit a card in f32.  Training takes the reference's layout,
f32 masters (``masters=True``), which every forward casts to
``cfg.dtype`` at use, as the reference does.  DLRM's 26 single-hot
lookups go through the embedding-bag kernel in one launch a forward
(differentiable: its grouped ``autograd.Function``) as bags of one id of
weight 1, which is the row itself, bit for bit, written into the
interaction's input; every other lookup is a plain gather, as in the
reference.

Top-k keeps the lower index first among equal scores, as
``jax.lax.top_k`` does (``top_ids``).

On a mesh (a step of ``train.trainer`` over DTensor params) each loss
takes this rank's rows of its batch and returns its share of the global
mean (``distributed.hooks``); two-tower's in-batch negatives are the
whole batch's, so its towers run on the gathered batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.embedding_bag.ops import embedding_bags
from repro_torch.models.attention import mha
from repro_torch.nn.layers import (
    cast_params,
    dense,
    dense_init,
    mlp_apply,
    mlp_init,
    rms_norm,
    softmax_xent,
)
from repro_torch.distributed.hooks import (
    active_mesh,
    batch_mean,
    gathered,
    local_batch,
    rows_like,
)
from repro_torch.sparse.embedding import embedding_lookup

Params = Dict[str, Any]

RETRIEVAL_K = 100
# DLRM candidates scored by one forward: each candidate's score depends on
# no other, and at 1M candidates one forward would hold about 30 GB of
# activations beside the tables
DLRM_RETRIEVAL_CHUNK = 262_144


def top_ids(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores, the lower index first among
    equal ones (a stable descending sort; ``torch.topk`` promises no
    order of ties)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits, in f32.  Its gradient at a
    logit of 0 is the reference's: ``maximum`` splits a tie in half in
    both packages, and ``|x|`` is taken as a ``where`` whose gradient at 0
    is 1, as ``jnp.abs``'s is (``torch.abs``'s is 0)."""
    lf = logits.float()
    abs_lf = torch.where(lf >= 0, lf, -lf)
    x = (torch.maximum(lf, torch.zeros_like(lf)) - lf * labels
         + torch.log1p(torch.exp(-abs_lf)))
    return batch_mean(torch.sum(x), x.numel())


def param_dtype(cfg: Any, masters: bool) -> torch.dtype:
    """The dtype parameters are held in: f32 masters for training (the
    reference's layout), else the compute dtype."""
    return torch.float32 if masters else cfg.dtype


def _table(gen: torch.Generator, rows: int, dim: int,
           dtype: torch.dtype) -> Params:
    """An N(0, 0.02^2) table drawn in ``dtype`` in place: no f32 copy of
    a 12 GB table is ever made."""
    t = torch.empty((rows, dim), dtype=dtype, device=gen.device)
    return {"table": t.normal_(0.0, 0.02, generator=gen)}


# ================================================================== DLRM ====
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    table_rows: Tuple[int, ...] = ()   # 26 Criteo-1TB cardinalities
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_sparse(self) -> int:
        return len(self.table_rows)


def dlrm_init(cfg: DLRMConfig, gen: torch.Generator,
              masters: bool = False) -> Params:
    n, dt = cfg.n_sparse, param_dtype(cfg, masters)
    return {
        "tables": {f"t{i}": _table(gen, rows, cfg.embed_dim, dt)
                   for i, rows in enumerate(cfg.table_rows)},
        "bot": cast_params(mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp), dt),
        "top": cast_params(
            mlp_init(gen, (cfg.embed_dim + (n + 1) * n // 2,) + cfg.top_mlp),
            dt),
    }


def dlrm_forward(cfg: DLRMConfig, p: Params, batch: Dict) -> torch.Tensor:
    """(B,) scores from ``dense`` (B, 13) and ``sparse`` (B, 26) ids: one
    embedding-bag launch for all 26 tables that writes each lookup into
    its slot of the interaction's input beside the bottom MLP's output,
    then the dot interaction of the 27 vectors in f32 and the top MLP.
    The bags read ids under the ``fill`` rule of the reference's
    ``embedding_lookup`` (``jnp.take``): an id in ``[-rows, 0)`` wraps,
    any other id outside its table gives a NaN row and so a NaN score."""
    dense_x = batch["dense"]
    sparse = batch["sparse"]
    B = dense_x.shape[0]
    d = mlp_apply(p["bot"], dense_x.to(cfg.dtype), dtype=cfg.dtype,
                  final_act=True)                                # (B, D)
    tables = [p["tables"][f"t{i}"]["table"] for i in range(cfg.n_sparse)]
    ids = sparse.to(torch.int32).t()[..., None]            # (26, B, 1) view
    ones = torch.ones((1, 1, 1), dtype=torch.float32,
                      device=dense_x.device).expand(cfg.n_sparse, B, 1)
    # each lookup is rounded to its table's dtype; where that is cfg.dtype
    # the bags go straight into the f32 input of the interaction (a bf16
    # value widens exactly), else into cfg.dtype and are widened after
    zdt = torch.float32 if tables[0].dtype == cfg.dtype else cfg.dtype
    z = embedding_bags(tables, ids, ones, id_rule="fill", dtype=zdt,
                       head=d)                                   # (B, 27, D)
    zf = z.float()
    inter = zf @ zf.transpose(1, 2)                              # (B, 27, 27)
    iu = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
    flat = inter[:, iu[0], iu[1]].to(cfg.dtype)                  # (B, 351)
    x = torch.cat([d, flat], dim=-1)
    return mlp_apply(p["top"], x, dtype=cfg.dtype)[:, 0]


def dlrm_loss(cfg: DLRMConfig, p: Params, batch: Dict) -> torch.Tensor:
    batch = local_batch(batch)
    return bce_logits(dlrm_forward(cfg, p, batch), batch["label"])


def dlrm_candidate_scores(cfg: DLRMConfig, p: Params,
                          batch: Dict) -> torch.Tensor:
    """One user context (``dense`` (1, 13), ``sparse`` (1, 26)) scored
    against ``candidates`` (N,) ids of table 0, in forwards of at most
    ``DLRM_RETRIEVAL_CHUNK`` candidates."""
    cand = batch["candidates"]
    out = []
    for s in range(0, cand.shape[0], DLRM_RETRIEVAL_CHUNK):
        c = cand[s:s + DLRM_RETRIEVAL_CHUNK]
        n = c.shape[0]
        sparse = batch["sparse"].expand(n, cfg.n_sparse).clone()
        sparse[:, 0] = c
        out.append(dlrm_forward(cfg, p, {
            "dense": batch["dense"].expand(n, cfg.n_dense),
            "sparse": sparse}))
    return torch.cat(out)


def dlrm_retrieval(cfg: DLRMConfig, p: Params, batch: Dict) -> torch.Tensor:
    """Score one user context against N candidate items (vary table 0)."""
    scores = dlrm_candidate_scores(cfg, p, batch)
    return top_ids(scores, min(RETRIEVAL_K, scores.shape[0]))


# =================================================================== DIN ====
@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cates: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.bfloat16


def din_init(cfg: DINConfig, gen: torch.Generator,
             masters: bool = False) -> Params:
    d, dt = cfg.embed_dim * 2, param_dtype(cfg, masters)  # item + category
    return {
        "item": _table(gen, cfg.n_items, cfg.embed_dim, dt),
        "cate": _table(gen, cfg.n_cates, cfg.embed_dim, dt),
        # attention MLP input: [e, t, e*t, e-t] -> 4d
        "attn": cast_params(mlp_init(gen, (4 * d,) + cfg.attn_mlp + (1,)), dt),
        "head": cast_params(mlp_init(gen, (3 * d,) + cfg.mlp + (1,)), dt),
    }


def _din_embed(cfg: DINConfig, p: Params, items, cates) -> torch.Tensor:
    return torch.cat([
        embedding_lookup(p["item"]["table"], items, cfg.dtype),
        embedding_lookup(p["cate"]["table"], cates, cfg.dtype),
    ], dim=-1)  # (..., 2 * embed_dim)


def din_forward(cfg: DINConfig, p: Params, batch: Dict) -> torch.Tensor:
    seq = _din_embed(cfg, p, batch["hist_items"], batch["hist_cates"])  # (B,S,d)
    mask = batch["hist_mask"]                                           # (B,S)
    tgt = _din_embed(cfg, p, batch["target_item"], batch["target_cate"])  # (B,d)
    t = tgt[:, None, :].expand_as(seq)
    att_in = torch.cat([seq, t, seq * t, seq - t], dim=-1)
    w = mlp_apply(p["attn"], att_in, dtype=cfg.dtype)[..., 0]           # (B,S)
    w = w.float().masked_fill(mask <= 0, -1e30)
    w = torch.softmax(w, dim=-1).to(cfg.dtype)
    user = torch.einsum("bs,bsd->bd", w, seq)                           # (B,d)
    x = torch.cat([user, tgt, user * tgt], dim=-1)
    return mlp_apply(p["head"], x, dtype=cfg.dtype)[:, 0]


def din_loss(cfg: DINConfig, p: Params, batch: Dict) -> torch.Tensor:
    batch = local_batch(batch)
    return bce_logits(din_forward(cfg, p, batch), batch["label"])


def din_candidate_scores(cfg: DINConfig, p: Params,
                         batch: Dict) -> torch.Tensor:
    """One history (1, seq_len) against ``candidates`` and
    ``candidate_cates`` (N,)."""
    n = batch["candidates"].shape[0]
    return din_forward(cfg, p, {
        "hist_items": batch["hist_items"].expand(n, cfg.seq_len),
        "hist_cates": batch["hist_cates"].expand(n, cfg.seq_len),
        "hist_mask": batch["hist_mask"].expand(n, cfg.seq_len),
        "target_item": batch["candidates"],
        "target_cate": batch["candidate_cates"],
    })


def din_retrieval(cfg: DINConfig, p: Params, batch: Dict) -> torch.Tensor:
    scores = din_candidate_scores(cfg, p, batch)
    return top_ids(scores, min(RETRIEVAL_K, scores.shape[0]))


# ================================================================ SASRec ====
@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 60_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16


def sasrec_init(cfg: SASRecConfig, gen: torch.Generator,
                masters: bool = False) -> Params:
    d, dt = cfg.embed_dim, param_dtype(cfg, masters)

    def ones():
        return torch.ones(d, device=gen.device)

    blocks = [
        {
            "ln1": ones(),
            "wq": dense_init(gen, d, d),
            "wk": dense_init(gen, d, d),
            "wv": dense_init(gen, d, d),
            "wo": dense_init(gen, d, d),
            "ln2": ones(),
            "fc1": dense_init(gen, d, d, bias=True),
            "fc2": dense_init(gen, d, d, bias=True),
        }
        for _ in range(cfg.n_blocks)
    ]
    return {
        "item": _table(gen, cfg.n_items, d, dt),
        "pos": _table(gen, cfg.seq_len, d, dt),
        "ln_f": ones(),
        "blocks": cast_params(blocks, dt),
    }


def sasrec_backbone(cfg: SASRecConfig, p: Params,
                    seq: torch.Tensor) -> torch.Tensor:
    """(B, S) item ids -> (B, S, d) causal self-attention states."""
    B, S = seq.shape
    d = cfg.embed_dim
    x = embedding_lookup(p["item"]["table"], seq, cfg.dtype)
    x = x + p["pos"]["table"].to(cfg.dtype)[None, :S]
    for blk in p["blocks"]:
        h = rms_norm(blk["ln1"], x)
        q = dense(blk["wq"], h, cfg.dtype).reshape(B, S, cfg.n_heads, -1)
        k = dense(blk["wk"], h, cfg.dtype).reshape(B, S, cfg.n_heads, -1)
        v = dense(blk["wv"], h, cfg.dtype).reshape(B, S, cfg.n_heads, -1)
        o = mha(q, k, v, causal=True).reshape(B, S, d)
        x = x + dense(blk["wo"], o, cfg.dtype)
        h = rms_norm(blk["ln2"], x)
        x = x + dense(blk["fc2"], torch.relu(dense(blk["fc1"], h, cfg.dtype)),
                      cfg.dtype)
    return rms_norm(p["ln_f"], x)


def sasrec_loss(cfg: SASRecConfig, p: Params, batch: Dict) -> torch.Tensor:
    """Next-item prediction, full softmax over items, computed in
    chunks of C positions (5 where S allows, as the reference's scan) so
    (B, S, n_items) logits are never materialized."""
    batch = local_batch(batch)
    h = sasrec_backbone(cfg, p, batch["seq"])                        # (B, S, d)
    B, S, d = h.shape
    C = 5 if S % 5 == 0 else 1
    hc = h.reshape(B, S // C, C, d).transpose(0, 1)
    lc = batch["labels"].reshape(B, S // C, C).transpose(0, 1)
    table = p["item"]["table"].to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.int32, device=h.device)
    for hh, ll in zip(hc, lc):
        logits = torch.einsum("bsd,vd->bsv", hh, table)
        cnt = (ll != -1).sum().to(torch.int32)
        tot = tot + softmax_xent(logits, ll) * cnt
        n = n + cnt
    return batch_mean(tot, n)


def sasrec_score(cfg: SASRecConfig, p: Params, batch: Dict) -> torch.Tensor:
    """Serving: last-position scores (B, C) for ``candidates`` (B, C)."""
    h = sasrec_backbone(cfg, p, batch["seq"])[:, -1]                  # (B, d)
    cand = embedding_lookup(p["item"]["table"], batch["candidates"], cfg.dtype)
    return torch.einsum("bd,bcd->bc", h, cand)


def sasrec_candidate_scores(cfg: SASRecConfig, p: Params,
                            batch: Dict) -> torch.Tensor:
    """One sequence (1, S) against ``candidates`` (N,)."""
    h = sasrec_backbone(cfg, p, batch["seq"])[:, -1]                  # (1, d)
    cand = embedding_lookup(p["item"]["table"], batch["candidates"], cfg.dtype)
    return torch.einsum("bd,cd->bc", h, cand)[0]


def sasrec_retrieval(cfg: SASRecConfig, p: Params, batch: Dict) -> torch.Tensor:
    scores = sasrec_candidate_scores(cfg, p, batch)
    return top_ids(scores, min(RETRIEVAL_K, scores.shape[0]))


# ============================================================= Two-tower ====
@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users: int = 10_000_000
    n_items: int = 2_000_000
    n_context: int = 100_000
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    temperature: float = 0.05
    dtype: torch.dtype = torch.bfloat16


def twotower_init(cfg: TwoTowerConfig, gen: torch.Generator,
                  masters: bool = False) -> Params:
    d, dt = cfg.embed_dim, param_dtype(cfg, masters)
    return {
        "user": _table(gen, cfg.n_users, d, dt),
        "ctx": _table(gen, cfg.n_context, d, dt),
        "item": _table(gen, cfg.n_items, d, dt),
        "icat": _table(gen, cfg.n_context, d, dt),
        "user_tower": cast_params(mlp_init(gen, (2 * d,) + cfg.tower_mlp), dt),
        "item_tower": cast_params(mlp_init(gen, (2 * d,) + cfg.tower_mlp), dt),
    }


def _tower(cfg: TwoTowerConfig, p: Params, tower: str, e: torch.Tensor
           ) -> torch.Tensor:
    out = mlp_apply(p[tower], e, dtype=cfg.dtype)
    return out / torch.linalg.norm(out.float(), dim=-1,
                                   keepdim=True).to(cfg.dtype)


def user_embed(cfg: TwoTowerConfig, p: Params, batch: Dict) -> torch.Tensor:
    e = torch.cat([
        embedding_lookup(p["user"]["table"], batch["user_id"], cfg.dtype),
        embedding_lookup(p["ctx"]["table"], batch["user_ctx"], cfg.dtype),
    ], dim=-1)
    return _tower(cfg, p, "user_tower", e)


def item_embed(cfg: TwoTowerConfig, p: Params, item_id,
               item_cat) -> torch.Tensor:
    e = torch.cat([
        embedding_lookup(p["item"]["table"], item_id, cfg.dtype),
        embedding_lookup(p["icat"]["table"], item_cat, cfg.dtype),
    ], dim=-1)
    return _tower(cfg, p, "item_tower", e)


def twotower_loss(cfg: TwoTowerConfig, p: Params, batch: Dict) -> torch.Tensor:
    """In-batch sampled softmax (the RecSys'19 retrieval objective).  On
    a mesh every row's negatives are the whole batch's items, so the
    towers run on the gathered batch and this rank takes its rows'
    share of the loss."""
    g = {k: gathered(v) for k, v in batch.items()}
    u = user_embed(cfg, p, g)                                       # (B, d)
    i = item_embed(cfg, p, g["item_id"], g["item_cat"])             # (B, d)
    logits = torch.einsum("bd,cd->bc", u, i).float() / cfg.temperature
    labels = torch.arange(u.shape[0], device=u.device)
    if active_mesh() is None:
        return softmax_xent(logits[:, None, :], labels[:, None])
    rows = rows_like(logits, batch["user_id"])
    mine = softmax_xent(rows[:, None, :],
                        rows_like(labels, batch["user_id"])[:, None])
    return batch_mean(mine * rows.shape[0], rows.shape[0])


def twotower_score(cfg: TwoTowerConfig, p: Params, batch: Dict) -> torch.Tensor:
    u = user_embed(cfg, p, batch)
    i = item_embed(cfg, p, batch["item_id"], batch["item_cat"])
    return torch.einsum("bd,bd->b", u, i) / cfg.temperature


def twotower_candidate_scores(cfg: TwoTowerConfig, p: Params,
                              batch: Dict) -> torch.Tensor:
    """One user against ``candidate_embs`` (N, d) precomputed, in f32.

    The candidate store is the paper's S-strategy in device form: one
    physically contiguous segment array scanned sequentially."""
    u = user_embed(cfg, p, batch)                                     # (1, d)
    cands = batch["candidate_embs"].to(cfg.dtype)
    return torch.einsum("bd,nd->bn", u, cands)[0].float()


def twotower_retrieval(cfg: TwoTowerConfig, p: Params,
                       batch: Dict) -> torch.Tensor:
    return top_ids(twotower_candidate_scores(cfg, p, batch), RETRIEVAL_K)
