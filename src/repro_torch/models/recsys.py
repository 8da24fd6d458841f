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
mean (``distributed.hooks``), computing as :class:`RecsysLoss` declares
to the step (:class:`RecsysPlan`): DLRM's and two-tower's MLPs on this
rank's columns over ``model`` where ``model`` divides a layer's width
(:func:`_column_dense`; DIN's computed whole, :func:`splits_columns`);
DLRM's and two-tower's tables looked up where their rows lie
(``distributed.row_parallel``: DLRM's in one grouped bag launch for each
set of axes that shard tables); DIN's and SASRec's tables gathered
whole.  Two-tower's towers run on this rank's rows, and its in-batch
negatives are the whole batch's items, gathered.

Serving on a mesh (``configs.families.RecsysBundle.serve_step``) takes
the same plan: every score and retrieval function takes ``plan`` (None
without a mesh: the same bits as before it existed).  A score call
returns this rank's rows' scores.  A retrieval over candidates that the
batch axes split (``RecsysPlan.candidates``, the reference's layout of
1,000,000 candidates or more) ranks this rank's block and merges the
blocks' top ids over those axes (``row_parallel.merge_top_ids``), so
every rank returns the top 100 of all candidates; over whole candidates
each rank ranks all of them and nothing is merged.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, Optional, Tuple

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
    batch_axes,
    batch_gather,
    batch_mean,
    local,
    local_batch,
)
from repro_torch.distributed.leaf_kinds import LOCAL
from repro_torch.distributed.row_parallel import (
    RowShard,
    block_rows,
    lookup_rows,
    merge_top_ids,
    row_shard,
)
from repro_torch.distributed.sharding import (
    RECSYS_MLP_W,
    RECSYS_RULES,
    rule_spec,
)
from repro_torch.distributed.tensor_parallel import (
    ModelGroup,
    copy_to_model,
    gather_from_model,
    model_group,
)
from repro_torch.obs import span
from repro_torch.sparse.embedding import embedding_lookup
from repro_torch.tree import flatten_with_path, path_name, unflatten

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


def _top(scores: torch.Tensor, k: Optional[int],
         plan: Optional[RecsysPlan]) -> torch.Tensor:
    """The ids of the top ``k`` candidates (``min(RETRIEVAL_K, N)`` of N
    where ``k`` is None) by ``scores``, this rank's block's where
    ``plan`` splits the candidates (their ids global, merged over the
    ranks: ``row_parallel.merge_top_ids``)."""
    block = None if plan is None else plan.candidates
    n = scores.shape[0] if block is None else block.rows
    k = min(RETRIEVAL_K, n) if k is None else k
    if block is None:
        return top_ids(scores, k)
    return merge_top_ids(scores, block, k)


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


# ============================================================ on a mesh ====
@dataclasses.dataclass(frozen=True)
class RecsysPlan:
    """How this rank computes a recsys loss or serving call on a mesh:
    its MLPs' columns over ``columns``, the ``model`` group
    (:func:`_mlp`; None where the arch computes its MLPs whole), each
    table of ``tables`` (by path) where its rows lie, as
    ``RECSYS_RULES`` lays it out on the mesh, and ``candidates``, this
    rank's block of a retrieval's candidates where the batch axes split
    them (None: whole on every rank)."""
    columns: Optional[ModelGroup]
    tables: Dict[str, RowShard]
    candidates: Optional[RowShard] = None


def row_tables(cfg: Any) -> Dict[str, Tuple[int, int]]:
    """The (rows, dim) by path of the tables that ``cfg``'s arch looks up
    where their rows lie on a mesh: DLRM's and two-tower's.  DIN's and
    SASRec's are gathered whole (a step of DIN looks up more rows than
    its tables hold; SASRec's item table is also its softmax's output
    layer)."""
    if isinstance(cfg, DLRMConfig):
        return {f"tables/t{i}/table": (rows, cfg.embed_dim)
                for i, rows in enumerate(cfg.table_rows)}
    if isinstance(cfg, TwoTowerConfig):
        d = cfg.embed_dim
        return {"user/table": (cfg.n_users, d),
                "ctx/table": (cfg.n_context, d),
                "item/table": (cfg.n_items, d),
                "icat/table": (cfg.n_context, d)}
    return {}


def splits_columns(cfg: Any) -> bool:
    """Whether ``cfg``'s arch computes its MLPs on a rank's columns over
    ``model`` (DLRM's and two-tower's, whose layers run once a batch
    row).  DIN's run once a history position, on (B, 100, .) inputs:
    gathering their outputs over ``model`` moves more bytes than
    gathering the weights, so they are computed whole (``launch.dryrun``
    of ``train_batch`` on (16, 16), counted on the H100's figures: 4.1
    ms of collectives whole against 9.8 split, for 0.03 ms of compute
    saved).  SASRec has no MLP that the rules split."""
    return isinstance(cfg, (DLRMConfig, TwoTowerConfig))


def recsys_plan(cfg: Any) -> Optional[RecsysPlan]:
    """The active model group's plan for ``cfg`` on the active mesh; None
    outside one (every table whole, every MLP whole).  A loss asks once a
    forward and passes it down (the backward may run on another thread,
    where neither context is set)."""
    mg = model_group()
    if mg is None:
        return None
    mesh = active_mesh()
    return RecsysPlan(mg if splits_columns(cfg) else None, {
        k: row_shard(mesh, rule_spec(RECSYS_RULES, k, shape, mesh)[0],
                     shape[0])
        for k, shape in row_tables(cfg).items()})


def recsys_model_dims(cfg: Any, params: Params, mg: ModelGroup) -> Any:
    """A tree like ``params``: ``leaf_kinds.LOCAL`` for each table of
    :func:`row_tables`, 1 for each MLP weight whose columns ``mg``
    divides where the arch splits them (:func:`splits_columns`;
    ``RECSYS_RULES`` lays them out by columns over ``model``), None for a
    leaf gathered whole."""
    rows, split = row_tables(cfg), splits_columns(cfg)
    out = []
    for path, leaf in flatten_with_path(params):
        name = path_name(path)
        if name in rows:
            out.append(LOCAL)
        elif (split and re.search(RECSYS_MLP_W, name)
              and leaf.shape[-1] % mg.size == 0):
            out.append(1)
        else:
            out.append(None)
    return unflatten(params, out)


class RecsysLoss:
    """``loss(cfg, params, batch)`` of a recsys arch as a train step's
    ``loss(params, batch)``.  It declares its split over a mesh
    (:meth:`model_dims`), so a step on a mesh computes on the MLPs'
    columns and on the tables where their rows lie (:func:`recsys_plan`)."""

    def __init__(self, loss: Any, cfg: Any):
        self.loss, self.cfg = loss, cfg

    def __call__(self, params: Params, batch: Dict) -> torch.Tensor:
        return self.loss(self.cfg, params, batch)

    def model_dims(self, params: Params, mg: ModelGroup) -> Any:
        """Each leaf's kind (:func:`recsys_model_dims`)."""
        return recsys_model_dims(self.cfg, params, mg)


def _column_dense(p: Params, x: torch.Tensor, dtype: torch.dtype,
                  mg: ModelGroup) -> torch.Tensor:
    """``nn.layers.dense`` of a layer whose ``w`` ``RECSYS_RULES`` splits
    by columns over ``mg``: where ``mg.size`` divides its width (its
    bias's, which is replicated), this rank holds its block of ``w``'s
    columns, computes them and gathers the whole output over ``model``
    (``tensor_parallel.gather_from_model``); its input and bias enter
    through ``copy_to_model``, so their gradients are the whole ones on
    every rank (a rank's columns reach only part of them).  A layer whose
    width ``mg.size`` does not divide is computed whole."""
    width = p["b"].shape[0]
    if width % mg.size:
        return dense(p, x, dtype=dtype)
    k = width // mg.size
    if p["w"].shape[1] != k:
        raise ValueError(f"w has {p['w'].shape[1]} columns, its block of "
                         f"{width} over {mg.size} is {k}")
    b = copy_to_model(p["b"], mg)[mg.rank * k:(mg.rank + 1) * k]
    y = copy_to_model(x, mg).to(dtype) @ p["w"].to(dtype) + b.to(dtype)
    return gather_from_model(y, mg)


def _mlp(p: Params, x: torch.Tensor, plan: Optional[RecsysPlan],
         dtype: torch.dtype, final_act: bool = False) -> torch.Tensor:
    """``nn.layers.mlp_apply``; under a ``plan`` that splits the MLPs,
    each layer on this rank's columns (:func:`_column_dense`), the same
    values."""
    if plan is None or plan.columns is None:
        return mlp_apply(p, x, dtype=dtype, final_act=final_act)
    return mlp_apply(p, x, dtype=dtype, final_act=final_act,
                     layer=functools.partial(_column_dense, mg=plan.columns))


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


def _ones(n: int, B: int, device) -> torch.Tensor:
    """(n, B, 1) weights of 1: single-hot bags, one element shared."""
    return torch.ones((1, 1, 1), dtype=torch.float32,
                      device=device).expand(n, B, 1)


def _dlrm_bags(cfg: DLRMConfig, plan: RecsysPlan, tables, sparse, head,
               dtype) -> torch.Tensor:
    """The interaction's input (B, 27, D) in ``dtype`` on a mesh: ``head``
    in slot 0 and each table's rows in its slot, the tables grouped by
    the axes that shard their rows, one bag launch a group (in the order
    of each group's first table): a replicated group looks up this
    rank's rows, a sharded one the ids gathered over its batch axes in
    its blocks' windows, summed over its axes
    (``row_parallel.lookup_rows``).  One group (every table on one set
    of axes, as on a one-rank mesh) writes its rows into their slots as
    the mesh-less forward does, a sharded one with zeros in slot 0
    through the sum and ``head`` written in after it; several groups'
    rows are joined into their slots, a copy of the input."""
    B, D = sparse.shape[0], head.shape[1]
    groups: Dict[Tuple[str, ...], list] = {}
    for i in range(cfg.n_sparse):
        groups.setdefault(plan.tables[f"tables/t{i}/table"].axes,
                          []).append(i)

    def bags(idx, ids, head, windows=None):
        return embedding_bags([tables[i] for i in idx], ids.t()[..., None],
                              _ones(len(idx), ids.shape[0], ids.device),
                              id_rule="fill", dtype=dtype, head=head,
                              windows=windows)

    def looked_up(axes, idx, head):
        ids = sparse[:, idx].to(torch.int32)                     # (B, n)
        if not axes:
            return bags(idx, ids, head)
        shards = [plan.tables[f"tables/t{i}/table"] for i in idx]
        windows = [s.window for s in shards]
        return lookup_rows(ids, shards[0], lambda g: bags(
            idx, g, None if head is None else torch.zeros(
                (g.shape[0], D), dtype=dtype, device=g.device), windows))

    if len(groups) == 1:
        (axes, idx), = groups.items()
        z = looked_up(axes, idx, head)
        if axes:
            z[:, 0] = head
        return z
    parts, slots = [head.to(dtype)[:, None]], [0]
    for axes, idx in groups.items():
        parts.append(looked_up(axes, idx, None))
        slots += [1 + i for i in idx]
    z = torch.cat(parts, 1)
    if slots != sorted(slots):
        z = z[:, torch.argsort(torch.tensor(slots, device=z.device))]
    return z


def dlrm_forward(cfg: DLRMConfig, p: Params, batch: Dict,
                 plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    """(B,) scores from ``dense`` (B, 13) and ``sparse`` (B, 26) ids: one
    embedding-bag launch for all 26 tables that writes each lookup into
    its slot of the interaction's input beside the bottom MLP's output,
    then the dot interaction of the 27 vectors in f32 and the top MLP.
    The bags read ids under the ``fill`` rule of the reference's
    ``embedding_lookup`` (``jnp.take``): an id in ``[-rows, 0)`` wraps,
    any other id outside its table gives a NaN row and so a NaN score.
    With ``plan`` (a step on a mesh) the tables are this rank's blocks,
    looked up where their rows lie, one launch for each set of axes that
    shard tables (:func:`_dlrm_bags`), and the MLPs compute on this
    rank's columns."""
    with span("dlrm.forward"):
        dense_x = batch["dense"]
        sparse = batch["sparse"]
        B = dense_x.shape[0]
        d = _mlp(p["bot"], dense_x.to(cfg.dtype), plan, cfg.dtype,
                 final_act=True)                                 # (B, D)
        tables = [p["tables"][f"t{i}"]["table"]
                  for i in range(cfg.n_sparse)]
        # each lookup is rounded to its table's dtype; where that is
        # cfg.dtype the bags go straight into the f32 input of the
        # interaction (a bf16 value widens exactly), else into cfg.dtype
        # and are widened after
        zdt = torch.float32 if tables[0].dtype == cfg.dtype else cfg.dtype
        if plan is None:
            ids = sparse.to(torch.int32).t()[..., None]    # (26, B, 1) view
            z = embedding_bags(tables, ids,
                               _ones(cfg.n_sparse, B, ids.device),
                               id_rule="fill", dtype=zdt,
                               head=d)                           # (B, 27, D)
        else:
            z = _dlrm_bags(cfg, plan, tables, sparse, d, zdt)
        zf = z.float()
        inter = zf @ zf.transpose(1, 2)                          # (B, 27, 27)
        iu = torch.triu_indices(z.shape[1], z.shape[1], 1, device=z.device)
        flat = inter[:, iu[0], iu[1]].to(cfg.dtype)              # (B, 351)
        x = torch.cat([d, flat], dim=-1)
        return _mlp(p["top"], x, plan, cfg.dtype)[:, 0]


def dlrm_loss(cfg: DLRMConfig, p: Params, batch: Dict) -> torch.Tensor:
    batch = local_batch(batch)
    return bce_logits(dlrm_forward(cfg, p, batch, recsys_plan(cfg)),
                      batch["label"])


def dlrm_candidate_scores(cfg: DLRMConfig, p: Params, batch: Dict,
                          plan: Optional[RecsysPlan] = None
                          ) -> torch.Tensor:
    """One user context (``dense`` (1, 13), ``sparse`` (1, 26)) scored
    against ``candidates`` (N,) ids of table 0, in forwards of at most
    ``DLRM_RETRIEVAL_CHUNK`` candidates.  Under ``plan`` the candidates
    are this rank's (its block, or all of them) and each forward looks
    the tables up where their rows lie: ``lookup_rows`` is a collective,
    so every rank runs the same forwards on chunks of the same sizes,
    for the same tables in the same order.  The blocks of split
    candidates are equal (``row_parallel.row_shard`` refuses others), so
    no rank's block ends before another's."""
    cand = batch["candidates"]
    out = []
    for s in range(0, cand.shape[0], DLRM_RETRIEVAL_CHUNK):
        c = cand[s:s + DLRM_RETRIEVAL_CHUNK]
        n = c.shape[0]
        sparse = batch["sparse"].expand(n, cfg.n_sparse).clone()
        sparse[:, 0] = c
        out.append(dlrm_forward(cfg, p, {
            "dense": batch["dense"].expand(n, cfg.n_dense),
            "sparse": sparse}, plan))
    return torch.cat(out)


def dlrm_retrieval(cfg: DLRMConfig, p: Params, batch: Dict,
                   plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    """Score one user context against N candidate items (vary table 0)."""
    return _top(dlrm_candidate_scores(cfg, p, batch, plan), None, plan)


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


def din_forward(cfg: DINConfig, p: Params, batch: Dict,
                plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    """(B,) scores; ``plan`` (a step on a mesh) splits no MLP of DIN's
    (:func:`splits_columns`)."""
    seq = _din_embed(cfg, p, batch["hist_items"], batch["hist_cates"])  # (B,S,d)
    mask = batch["hist_mask"]                                           # (B,S)
    tgt = _din_embed(cfg, p, batch["target_item"], batch["target_cate"])  # (B,d)
    t = tgt[:, None, :].expand_as(seq)
    att_in = torch.cat([seq, t, seq * t, seq - t], dim=-1)
    w = _mlp(p["attn"], att_in, plan, cfg.dtype)[..., 0]              # (B,S)
    w = w.float().masked_fill(mask <= 0, -1e30)
    w = torch.softmax(w, dim=-1).to(cfg.dtype)
    user = torch.einsum("bs,bsd->bd", w, seq)                           # (B,d)
    x = torch.cat([user, tgt, user * tgt], dim=-1)
    return _mlp(p["head"], x, plan, cfg.dtype)[:, 0]


def din_loss(cfg: DINConfig, p: Params, batch: Dict) -> torch.Tensor:
    batch = local_batch(batch)
    return bce_logits(din_forward(cfg, p, batch, recsys_plan(cfg)),
                      batch["label"])


def din_candidate_scores(cfg: DINConfig, p: Params, batch: Dict,
                         plan: Optional[RecsysPlan] = None
                         ) -> torch.Tensor:
    """One history (1, seq_len) against ``candidates`` and
    ``candidate_cates`` (N,)."""
    n = batch["candidates"].shape[0]
    return din_forward(cfg, p, {
        "hist_items": batch["hist_items"].expand(n, cfg.seq_len),
        "hist_cates": batch["hist_cates"].expand(n, cfg.seq_len),
        "hist_mask": batch["hist_mask"].expand(n, cfg.seq_len),
        "target_item": batch["candidates"],
        "target_cate": batch["candidate_cates"],
    }, plan)


def din_retrieval(cfg: DINConfig, p: Params, batch: Dict,
                  plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    return _top(din_candidate_scores(cfg, p, batch, plan), None, plan)


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


def sasrec_score(cfg: SASRecConfig, p: Params, batch: Dict,
                 plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    """Serving: last-position scores (B, C) for ``candidates`` (B, C).
    A ``plan`` splits nothing of SASRec's (its tables are gathered
    whole, and the rules split none of its weights)."""
    h = sasrec_backbone(cfg, p, batch["seq"])[:, -1]                  # (B, d)
    cand = embedding_lookup(p["item"]["table"], batch["candidates"], cfg.dtype)
    return torch.einsum("bd,bcd->bc", h, cand)


def sasrec_candidate_scores(cfg: SASRecConfig, p: Params, batch: Dict,
                            plan: Optional[RecsysPlan] = None
                            ) -> torch.Tensor:
    """One sequence (1, S) against ``candidates`` (N,)."""
    h = sasrec_backbone(cfg, p, batch["seq"])[:, -1]                  # (1, d)
    cand = embedding_lookup(p["item"]["table"], batch["candidates"], cfg.dtype)
    return torch.einsum("bd,cd->bc", h, cand)[0]


def sasrec_retrieval(cfg: SASRecConfig, p: Params, batch: Dict,
                     plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    return _top(sasrec_candidate_scores(cfg, p, batch, plan), None, plan)


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


def _tower(cfg: TwoTowerConfig, p: Params, tower: str, e: torch.Tensor,
           plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    out = _mlp(p[tower], e, plan, cfg.dtype)
    return out / torch.linalg.norm(out.float(), dim=-1,
                                   keepdim=True).to(cfg.dtype)


def _lookup(cfg: TwoTowerConfig, p: Params, name: str, ids: torch.Tensor,
            plan: Optional[RecsysPlan]) -> torch.Tensor:
    """``embedding_lookup`` of table ``name``, where its rows lie on a
    mesh (``row_parallel.lookup_rows`` of ``block_rows``) under ``plan``."""
    table = p[name]["table"]
    shard = None if plan is None else plan.tables.get(f"{name}/table")
    if shard is None:
        return embedding_lookup(table, ids, cfg.dtype)
    return lookup_rows(ids, shard, lambda g: block_rows(
        table, g, shard.window, cfg.dtype))


def user_embed(cfg: TwoTowerConfig, p: Params, batch: Dict,
               plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    e = torch.cat([_lookup(cfg, p, "user", batch["user_id"], plan),
                   _lookup(cfg, p, "ctx", batch["user_ctx"], plan)], dim=-1)
    return _tower(cfg, p, "user_tower", e, plan)


def item_embed(cfg: TwoTowerConfig, p: Params, item_id, item_cat,
               plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    e = torch.cat([_lookup(cfg, p, "item", item_id, plan),
                   _lookup(cfg, p, "icat", item_cat, plan)], dim=-1)
    return _tower(cfg, p, "item_tower", e, plan)


def twotower_loss(cfg: TwoTowerConfig, p: Params, batch: Dict) -> torch.Tensor:
    """In-batch sampled softmax (the RecSys'19 retrieval objective).  On
    a mesh each rank looks up and runs both towers on its own rows
    (under :func:`recsys_plan`) and scores them against the whole
    batch's items, gathered over the batch axes differentiably
    (``hooks.batch_gather``; none where the batch is replicated): its
    (b, B) logits, labels offset by its first global row, and its share
    of the mean through ``batch_mean``, the rows the reference's GSPMD
    step computes a rank."""
    plan = recsys_plan(cfg)
    axes = None
    if local(batch["user_id"]).shape[0] != batch["user_id"].shape[0]:
        axes = batch_axes()
    batch = local_batch(batch)
    u = user_embed(cfg, p, batch, plan)                             # (b, d)
    i = item_embed(cfg, p, batch["item_id"], batch["item_cat"], plan)
    if active_mesh() is None:
        logits = torch.einsum("bd,cd->bc", u, i).float() / cfg.temperature
        labels = torch.arange(u.shape[0], device=u.device)
        return softmax_xent(logits[:, None, :], labels[:, None])
    items = batch_gather(i, axes)                                   # (B, d)
    logits = torch.einsum("bd,cd->bc", u, items).float() / cfg.temperature
    b = u.shape[0]
    labels = torch.arange(b, device=u.device) + (
        0 if axes is None else axes.rank * b)
    mine = softmax_xent(logits[:, None, :], labels[:, None])
    return batch_mean(mine * b, b)


def twotower_score(cfg: TwoTowerConfig, p: Params, batch: Dict,
                   plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    u = user_embed(cfg, p, batch, plan)
    i = item_embed(cfg, p, batch["item_id"], batch["item_cat"], plan)
    return torch.einsum("bd,bd->b", u, i) / cfg.temperature


def twotower_candidate_scores(cfg: TwoTowerConfig, p: Params, batch: Dict,
                              plan: Optional[RecsysPlan] = None
                              ) -> torch.Tensor:
    """One user against ``candidate_embs`` (N, d) precomputed, in f32.
    Under ``plan`` the user's row, the same on every rank, is looked up
    where its tables' rows lie (each rank gets its own copy back) and
    its tower computed on the ``model`` columns.

    The candidate store is the paper's S-strategy in device form: one
    physically contiguous segment array scanned sequentially."""
    u = user_embed(cfg, p, batch, plan)                               # (1, d)
    cands = batch["candidate_embs"].to(cfg.dtype)
    return torch.einsum("bd,nd->bn", u, cands)[0].float()


def twotower_retrieval(cfg: TwoTowerConfig, p: Params, batch: Dict,
                       plan: Optional[RecsysPlan] = None) -> torch.Tensor:
    return _top(twotower_candidate_scores(cfg, p, batch, plan), RETRIEVAL_K,
                plan)
