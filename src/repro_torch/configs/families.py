"""Family bundles, the port of ``repro.configs.families``.

  * LM (:class:`LMBundle`, the reference's ``lm_bundle``): the config,
    its init, the ``train_4k`` loss and train step with the config's
    microbatches and optimizer, the serve step of the other three cells
    (``models.transformer.prefill`` and ``decode_step``, on a mesh on
    the weights' ``model`` shards), and the (batch, sequence) shapes of
    the four cells.
  * RecSys (:class:`RecsysServing`, :class:`RecsysTraining`, gathered
    in :class:`RecsysBundle`; the reference's ``recsys_bundle``): each
    arch's config with its score and retrieval functions, the batch
    sizes of its cells and its candidate count (cells ``serve_p99``,
    ``serve_bulk`` and ``retrieval_cand``, whose serve step
    :meth:`RecsysBundle.serve_step` computes on a mesh on the rules'
    shards and merges a retrieval's top ids over the ranks that split
    the candidates), and for its ``train_batch`` cell the loss, the
    optimizer settings and the train step.
  * GNN (:class:`GNNCell`, gathered in :class:`GNNBundle`; the
    reference's ``gnn_bundle``): MACE in its four cells, each with the
    dataset's config, its init, its loss and train step under the
    bundle's optimizer, and the shapes of its batch; the bundle's full
    and REDUCED sizes.

Every bundle also carries the reference's sharding surface
(:class:`_Sharded`): its family's ``rules``, ``param_shardings(mesh)``
and ``opt_shardings(mesh)``, ``abstract_params()`` and
``abstract_opt()`` (meta tensors: no memory), and for each cell
``abstract_inputs(cell)`` and ``input_sharding(cell, mesh)``, the
reference's ``CellSpec.inputs`` and ``input_sharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.hooks import local, use_mesh
from repro_torch.distributed.row_parallel import row_shard
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.distributed.tensor_parallel import (
    MODEL,
    model_group_of,
    use_model_group,
)
from repro_torch.models import mace as M
from repro_torch.models import recsys as RS
from repro_torch.models import transformer as TF
from repro_torch.models.attention import slot_block_table, slot_page
from repro_torch.models.gnn_common import NeighborSampler
from repro_torch.train.optim import OptConfig, adamw_init
from repro_torch.train.trainer import (
    TrainerConfig,
    _compute_leaf,
    build_train_step,
)
from repro_torch.tree import tree_map

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# families.py:90-95 of the reference: (batch, sequence) of each LM cell
LM_CELL_SHAPES = {"train_4k": (256, 4096), "prefill_32k": (32, 32768),
                  "decode_32k": (128, 32768), "long_500k": (1, 524288)}
# the reference configs' bundles at REDUCED
REDUCED_LM_CELL_SHAPES = {"train_4k": (4, 64), "prefill_32k": (2, 64),
                          "decode_32k": (4, 64), "long_500k": (1, 128)}

# families.py:334-336 of the reference
RECSYS_BATCH_SIZES = {"train_batch": 65_536, "serve_p99": 512,
                      "serve_bulk": 262_144}
# families.py:337: the recsys bundle's optimizer
RECSYS_OPT = OptConfig(lr=1e-3, weight_decay=1e-5, schedule="const",
                       warmup_steps=100, total_steps=100_000)


Shape = Tuple[Tuple[int, ...], torch.dtype]


class _MetaFactories(TorchFunctionMode):
    """Inside, a factory call that names its device makes a meta tensor,
    and a draw takes no generator: an init runs without memory."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        kwargs.pop("generator", None)
        return func(*args, **kwargs)


def abstract(draw: Callable[[torch.Generator], Any]) -> Any:
    """``draw(gen)`` as meta tensors: the shapes and dtypes of what it
    would draw (the reference's ``jax.eval_shape``)."""
    with torch.device("meta"), _MetaFactories():
        return draw(torch.Generator())


def meta_inputs(inputs: Dict[str, Shape]) -> Dict[str, torch.Tensor]:
    """``{name: (shape, dtype)}`` as meta tensors."""
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in inputs.items()}


def batch_sharded(mesh: Any, tree: Any) -> Any:
    """Every leaf's dim 0 over the batch axes (a scalar replicated): the
    reference's ``P(batch_spec(mesh)[0], None, ...)`` cell specs."""
    b = shd.batch_spec(mesh)[0]
    return tree_map(lambda leaf: NamedSharding(
        mesh, P(b, *([None] * (leaf.dim() - 1))) if leaf.dim() else P()),
        tree)


class _Sharded:
    """The reference bundle's sharding surface; a bundle gives ``rules``,
    ``abstract_params()`` and the cells' ``abstract_inputs(cell)``."""

    rules: ClassVar[list]

    def abstract_opt(self) -> Any:
        return adamw_init(self.abstract_params())

    def param_shardings(self, mesh: Any) -> Any:
        return shd.shard_by_rules(self.abstract_params(), mesh, self.rules)

    def opt_shardings(self, mesh: Any) -> Dict:
        pshard = self.param_shardings(mesh)
        return {"mu": pshard, "nu": pshard,
                "step": NamedSharding(mesh, P())}

    def input_sharding(self, cell: str, mesh: Any) -> Dict:
        """``{"batch": NamedSharding tree}``: dim 0 of every input over
        the batch axes."""
        return {"batch": batch_sharded(mesh,
                                       self.abstract_inputs(cell)["batch"])}

    def serve_params(self, cell: str, params: Any) -> Any:
        """The part of a params tree that ``cell``'s serve step reads (the
        reference's jitted cell takes no other argument): all of it."""
        return params


@dataclasses.dataclass(frozen=True)
class RecsysServing:
    name: str
    config: Any
    init: Callable          # (cfg, torch.Generator) -> params
    score: Callable         # (cfg, params, batch) -> scores
    candidate_scores: Callable  # (cfg, params, batch) -> the scores ranked
    retrieval: Callable     # (cfg, params, batch) -> top ids of those
    batch_sizes: Dict[str, int]
    n_candidates: int       # candidates of one retrieval call
    serve_candidates: Optional[int] = None  # per row, where scoring takes them
    # the top-level params a retrieval call reads, where it reads not all
    # (two-tower's query side: its candidates come as embeddings)
    retrieval_reads: Optional[Tuple[str, ...]] = None
    # the reference's abstract inputs: train(B), serve(B), retrieval()
    train_inputs: Optional[Callable[[int], Dict[str, Shape]]] = None
    serve_inputs: Optional[Callable[[int], Dict[str, Shape]]] = None
    retrieval_inputs: Optional[Callable[[], Dict[str, Shape]]] = None


def _train_fn(loss_fn: Callable, opt: OptConfig, microbatches: int = 1):
    return build_train_step(loss_fn, TrainerConfig(opt=opt,
                                                   microbatches=microbatches))


@dataclasses.dataclass(frozen=True)
class LMBundle(_Sharded):
    """An LM arch's cells.  ``shapes[cell]`` is the (batch, sequence) of
    ``train_4k`` and ``prefill_32k`` and the (slots, S_max) of the two
    decode cells; ``train_4k`` accumulates over ``microbatches``."""
    name: str
    config: TF.TransformerConfig
    shapes: Dict[str, Tuple[int, int]]
    microbatches: int = 1
    opt: OptConfig = OptConfig()
    family: str = "lm"
    rules: ClassVar[list] = shd.LM_RULES

    def abstract_params(self):
        return abstract(lambda g: TF.init_params(self.config, g, masters=True))

    def abstract_inputs(self, cell: str) -> Dict:
        """The cell's inputs as meta tensors.  A decode cell's cache is
        the port's head-major (L, B, n_kv, S_max, D), where the
        reference's is (L, B, S_max, n_kv, D)."""
        cfg, (B, S) = self.config, self.shapes[cell]
        i32 = torch.int32
        if cell == "train_4k":
            return {"batch": meta_inputs({"tokens": ((B, S), i32),
                                          "labels": ((B, S), i32)})}
        if cell == "prefill_32k":
            return {"batch": meta_inputs({"tokens": ((B, S), i32)})}
        kv = ((cfg.n_layers, B, cfg.n_kv_heads, S, cfg.d_head), cfg.dtype)
        return {"batch": {"token": torch.empty((B,), dtype=i32, device="meta"),
                          "cache": meta_inputs({"k": kv, "v": kv,
                                                "len": ((B,), i32)})}}

    def input_sharding(self, cell: str, mesh: Any) -> Dict:
        if cell in ("train_4k", "prefill_32k"):
            return super().input_sharding(cell, mesh)
        b = shd.batch_spec(mesh)[0]
        kv = NamedSharding(mesh, P(None, b, None, "model", None))  # S on model
        return {"batch": {"token": NamedSharding(mesh, P(b)),
                          "cache": {"k": kv, "v": kv,
                                    "len": NamedSharding(mesh, P(b))}}}

    @property
    def cells(self) -> Tuple[str, ...]:
        return LM_SHAPES

    def init(self, gen: torch.Generator, masters: bool = True):
        """Parameters drawn on ``gen``'s device: f32 masters (the
        reference bundle's init), or with ``masters=False`` the serving
        layout in ``config.dtype``."""
        return TF.init_params(self.config, gen, masters=masters)

    def loss_fn(self) -> Callable:
        """``loss(params, batch)``: ``lm_loss`` of ``batch["tokens"]``
        against ``batch["labels"]`` (``TF.LMLoss``: on a mesh, the step
        computes on the weights' ``model`` shards)."""
        return TF.LMLoss(self.config)

    def train_step(self):
        """The ``train_4k`` cell's ``step(params, opt_state, batch)``; it
        donates ``params`` and ``opt_state`` (updates them in place)."""
        return _train_fn(self.loss_fn(), self.opt, self.microbatches)

    def serve_step(self, cell: str) -> Callable:
        """A serve cell's ``step(params, batch) -> (logits, cache)``, the
        reference bundle's ``prefill_step`` (``prefill_32k``) and
        ``decode_step`` (``decode_32k``, ``long_500k``): ``prefill`` of
        ``batch["tokens"]`` or ``decode_step`` of ``batch["token"]`` on
        ``batch["cache"]`` (``k``, ``v``, ``len``; ``page`` and ``table``
        made for its sequence when absent), under ``torch.no_grad``.

        ``params`` are the serving layout (:meth:`init` with
        ``masters=False``), plain or placed by :meth:`param_shardings`
        (DTensors); ``batch`` is laid out as :meth:`abstract_inputs`
        gives it, plain, placed by :meth:`input_sharding` or as this
        rank's blocks of that.  On a mesh the step gathers each leaf over
        the batch axes at once, keeping its ``model`` shard where the
        LM's plan splits it (the train step's rule:
        ``models.transformer.lm_model_dims``), and computes inside
        ``use_mesh`` and ``use_model_group`` on this rank's rows: the
        weights' ``model`` shards, and a decode cache's block of the
        sequence (the cell's layout).  It returns this rank's rows'
        whole logits and the cache dict of ``prefill`` or
        ``decode_step`` (a decode cache's local blocks, updated in
        place)."""
        cfg = self.config
        if cell not in ("prefill_32k", "decode_32k", "long_500k"):
            raise ValueError(f"{cell} is not a serve cell")

        def step(params: Any, batch: Dict) -> Tuple[torch.Tensor, Dict]:
            mesh = shd.mesh_of(params)
            mg = model_group_of(mesh)
            dims = (tree_map(lambda p: None, params) if mg is None
                    else TF.lm_model_dims(cfg, params, mg))
            if cell != "prefill_32k" and mg is not None:
                _check_sequence_split(batch["cache"]["k"])
            with torch.no_grad(), use_mesh(mesh):
                full = tree_map(_compute_leaf, params, dims)
                with use_model_group(mg):
                    if cell == "prefill_32k":
                        return TF.prefill(cfg, full, local(batch["tokens"]))
                    cache = {k: local(v) for k, v in batch["cache"].items()}
                    if "table" not in cache:
                        B, n_kv, S = cache["k"].shape[1:4]
                        cache["page"] = slot_page(S, TF.DEFAULT_PAGE)
                        cache["table"] = slot_block_table(
                            B, n_kv, S, cache["page"], cache["k"].device)
                    return TF.decode_step(cfg, full, local(batch["token"]),
                                          cache)

        return step


def _check_sequence_split(k: Any) -> None:
    """A decode cache placed on a mesh with a ``model`` axis must hold
    its sequence (dim 3) split over it, as the cell's layout does."""
    if not shd.is_sharded(k):
        return
    names = k.device_mesh.mesh_dim_names
    if MODEL in names and k.placements[names.index(MODEL)] != shd.Shard(3):
        raise ValueError(f"the decode cache is placed {k.placements}: its "
                         f"sequence (dim 3) must be split over {MODEL!r}")


def lm_bundle(name: str, cfg: TF.TransformerConfig,
              shapes: Optional[Dict[str, Tuple[int, int]]] = None,
              opt: Optional[OptConfig] = None,
              microbatches: int = 1) -> LMBundle:
    # padded head sharding everywhere, as the reference's bundle sets it
    cfg = dataclasses.replace(cfg, att_shard="heads")
    return LMBundle(name=name, config=cfg,
                    shapes=dict(shapes or LM_CELL_SHAPES),
                    microbatches=microbatches, opt=opt or OptConfig())


@dataclasses.dataclass(frozen=True)
class RecsysTraining:
    """The ``train_batch`` cell: ``init(cfg, gen, masters=True)`` draws
    the f32 masters, ``loss(cfg, params, batch)`` is the objective."""
    name: str
    config: Any
    init: Callable
    loss: Callable
    batch_size: int
    opt: OptConfig = RECSYS_OPT

    def loss_fn(self) -> Callable:
        """``loss(params, batch)`` at this config (``RS.RecsysLoss``: on a
        mesh, the step computes on the MLPs' columns over ``model`` and
        on DLRM's and two-tower's tables where their rows lie)."""
        return RS.RecsysLoss(self.loss, self.config)

    def train_step(self):
        """The cell's ``step(params, opt_state, batch)``; it donates
        ``params`` and ``opt_state`` (updates them in place)."""
        return _train_fn(self.loss_fn(), self.opt)


def recsys_training(sv: RecsysServing, loss: Callable) -> RecsysTraining:
    """The training cell of the arch that ``sv`` serves."""
    return RecsysTraining(name=sv.name, config=sv.config, init=sv.init,
                          loss=loss, batch_size=sv.batch_sizes["train_batch"])


@dataclasses.dataclass(frozen=True)
class RecsysBundle(_Sharded):
    """A recsys arch's four cells: ``serving`` has the three serve cells,
    ``training`` the ``train_batch`` cell."""
    name: str
    serving: RecsysServing
    training: RecsysTraining
    family: str = "recsys"
    rules: ClassVar[list] = shd.RECSYS_RULES

    def abstract_params(self):
        return abstract(lambda g: self.training.init(self.config, g,
                                                     masters=True))

    def abstract_inputs(self, cell: str) -> Dict:
        sv = self.serving
        if cell == "train_batch":
            inputs = sv.train_inputs(sv.batch_sizes[cell])
        elif cell == "retrieval_cand":
            inputs = sv.retrieval_inputs()
        else:
            inputs = sv.serve_inputs(sv.batch_sizes[cell])
        return {"batch": meta_inputs(inputs)}

    def input_sharding(self, cell: str, mesh: Any) -> Dict:
        """Dim 0 over the batch axes; in ``retrieval_cand`` only for an
        input of at least 1,000,000 rows (the candidates), as in the
        reference."""
        if cell != "retrieval_cand":
            return super().input_sharding(cell, mesh)
        b = shd.batch_spec(mesh)[0]
        return {"batch": tree_map(lambda leaf: NamedSharding(
            mesh, P(b, *([None] * (leaf.dim() - 1)))
            if leaf.dim() and leaf.shape[0] >= 1_000_000
            else P(*([None] * leaf.dim()))),
            self.abstract_inputs(cell)["batch"])}

    @property
    def config(self) -> Any:
        return self.serving.config

    @property
    def cells(self) -> Tuple[str, ...]:
        return RECSYS_SHAPES

    def init(self, gen: torch.Generator, masters: bool = True):
        """Parameters drawn on ``gen``'s device: f32 masters (the
        reference bundle's init), or with ``masters=False`` the serving
        layout in ``config.dtype``."""
        return self.training.init(self.config, gen, masters=masters)

    def serve_params(self, cell: str, params: Any) -> Any:
        """The part of a params tree that ``cell``'s serve step reads: in
        ``retrieval_cand`` the arch's ``retrieval_reads`` where it names
        them (jit drops the reference's unused arguments), else all."""
        keys = self.serving.retrieval_reads
        if cell != "retrieval_cand" or keys is None:
            return params
        return {k: params[k] for k in keys}

    def serve_step(self, cell: str) -> Callable:
        """A serve cell's ``step(params, batch)``, the reference bundle's
        ``serve_step`` (``serve_p99``, ``serve_bulk``: the arch's score
        function, (B,) or (B, C) scores) and ``retrieval_step``
        (``retrieval_cand``: its retrieval function, the ids of the top
        100 candidates), under ``torch.no_grad``.

        ``params`` are the serving layout (:meth:`init` with
        ``masters=False``), plain or placed by :meth:`param_shardings`
        (DTensors; the rules match by path, so the serving dtype takes
        the masters' specs); ``batch`` is laid out as
        :meth:`abstract_inputs` gives it, plain, placed by
        :meth:`input_sharding` or as this rank's blocks of that (plain
        candidates are taken whole).  It reads only the params of
        :meth:`serve_params`.  Without a mesh the step is the
        score or retrieval call itself, bit for bit.  On a mesh (which
        must have a ``model`` axis) it computes as the training step's
        route does (``models.recsys.recsys_model_dims`` read by the
        trainer's ``_compute_leaf``, inside ``use_mesh`` and
        ``use_model_group`` with ``recsys_plan``): DLRM's and
        two-tower's tables looked up where their rows lie, never
        gathered, their MLP weights on their ``model`` columns, DIN's
        and SASRec's tables gathered whole.  A score cell returns this
        rank's rows' scores.  A retrieval over candidates split over the
        batch axes ranks this rank's block and merges the blocks' top ids
        over those axes (:func:`_candidate_block`, ``RecsysPlan
        .candidates``), so every rank returns the top 100 of all of them,
        as the reference's ``jax.lax.top_k`` over all N does; over whole
        candidates each rank ranks them all."""
        sv, cfg = self.serving, self.config
        if cell == "retrieval_cand":
            fn = sv.retrieval
        elif cell in ("serve_p99", "serve_bulk"):
            fn = sv.score
        else:
            raise ValueError(f"{cell} is not a serve cell")

        def step(params: Any, batch: Dict) -> torch.Tensor:
            params = self.serve_params(cell, params)
            mesh = shd.mesh_of(params)
            if mesh is None:
                with torch.no_grad():
                    return fn(cfg, params, batch)
            mg = model_group_of(mesh)
            if mg is None:
                raise ValueError("a recsys serve step on a mesh computes "
                                 f"over its {MODEL!r} axis; the mesh has "
                                 f"{mesh.mesh_dim_names}")
            block = (_candidate_block(batch, mesh)
                     if cell == "retrieval_cand" else None)
            dims = RS.recsys_model_dims(cfg, params, mg)
            with torch.no_grad(), use_mesh(mesh):
                full = tree_map(_compute_leaf, params, dims)
                with use_model_group(mg):
                    plan = dataclasses.replace(RS.recsys_plan(cfg),
                                               candidates=block)
                    return fn(cfg, full, {k: local(v)
                                          for k, v in batch.items()}, plan)

        return step


def _candidate_block(batch: Dict, mesh: Any) -> Optional[Any]:
    """This rank's block of a retrieval's candidates (``candidates``, or
    two-tower's ``candidate_embs``) as a ``row_parallel.RowShard`` where
    they are a DTensor whose dim 0 the batch axes split, else None
    (whole on every rank).  Every other input of as many rows must be
    laid out as they are; a split over ``model`` (whose ranks compute
    the same rows) or of another dim is refused, as are blocks of
    unequal sizes."""
    key = "candidates" if "candidates" in batch else "candidate_embs"
    x = batch[key]
    if not shd.is_sharded(x):
        return None
    names = x.device_mesh.mesh_dim_names
    axes = tuple(names[i] for i, pl in enumerate(x.placements)
                 if isinstance(pl, shd.Shard))
    if MODEL in axes or any(pl != shd.Shard(0) for pl in x.placements
                            if isinstance(pl, shd.Shard)):
        raise ValueError(f"the candidates are placed {x.placements}: only "
                         "their rows may be split, over the batch axes")
    for k, v in batch.items():
        if (k != key and v.dim() and v.shape[0] == x.shape[0]
                and tuple(getattr(v, "placements", ())) != x.placements):
            raise ValueError(f"{k} is not laid out as {key}")
    if not axes:
        return None
    return row_shard(mesh, axes, x.shape[0])


# ================================================================= GNN =====
# families.py:194-195 of the reference: the GNN bundle's optimizer
GNN_OPT = OptConfig(lr=1e-3, weight_decay=0.0, schedule="cosine",
                    warmup_steps=10, total_steps=1000)
# families.py:204-214: (nodes, edges) of Cora and of ogbn-products, the
# sampled cell's (seeds, fanout), the molecule cell's (graphs, nodes a
# graph, edges a graph)
GNN_SIZES = {"cora": (2708, 10556), "products": (2_449_029, 61_859_140),
             "mb_seeds": (1024, (15, 10)), "mol": (128, 30, 64)}
REDUCED_GNN_SIZES = {"cora": (128, 512), "products": (256, 1024),
                     "mb_seeds": (8, (3, 2)), "mol": (4, 10, 16)}

@dataclasses.dataclass(frozen=True)
class GNNCell:
    """One GNN cell: ``config`` (the bundle's base with the dataset's
    ``d_feat`` and ``n_out``), ``loss(cfg, params, batch)``, the shape
    and dtype of each batch input, and the bundle's optimizer."""
    name: str
    config: M.MACEConfig
    loss: Callable
    inputs: Dict[str, Shape]
    opt: OptConfig = GNN_OPT

    def init(self, gen: torch.Generator):
        """f32 parameters on ``gen``'s device."""
        return M.mace_init(self.config, gen)

    def loss_fn(self) -> Callable:
        """``loss(params, batch)`` at this cell's config."""
        return lambda p, b: self.loss(self.config, p, b)

    def train_step(self):
        """``step(params, opt_state, batch)``; it donates ``params`` and
        ``opt_state`` (updates them in place)."""
        return _train_fn(self.loss_fn(), self.opt)

    def abstract_inputs(self) -> Dict:
        return {"batch": meta_inputs(self.inputs)}

    def input_sharding(self, mesh: Any) -> Dict:
        return {"batch": batch_sharded(mesh, self.abstract_inputs()["batch"])}


@dataclasses.dataclass(frozen=True)
class GNNBundle(_Sharded):
    """MACE's four cells (``cell_specs``, in ``GNN_SHAPES`` order) and the
    sizes they were built at; ``init`` is the Cora cell's, as the
    reference bundle's is."""
    name: str
    config: M.MACEConfig
    sizes: Dict[str, tuple]
    cell_specs: Dict[str, GNNCell]
    family: str = "gnn"
    rules: ClassVar[list] = shd.GNN_RULES

    def abstract_params(self):
        return abstract(self.cell_specs["full_graph_sm"].init)

    def abstract_inputs(self, cell: str) -> Dict:
        return self.cell_specs[cell].abstract_inputs()

    def input_sharding(self, cell: str, mesh: Any) -> Dict:
        return self.cell_specs[cell].input_sharding(mesh)

    @property
    def cells(self) -> Tuple[str, ...]:
        return GNN_SHAPES

    @property
    def cell_configs(self) -> Dict[str, M.MACEConfig]:
        return {c: spec.config for c, spec in self.cell_specs.items()}

    @property
    def cell_inits(self) -> Dict[str, Callable]:
        return {c: spec.init for c, spec in self.cell_specs.items()}

    def init(self, gen: torch.Generator):
        return self.cell_specs["full_graph_sm"].init(gen)


def _node_inputs(cfg: M.MACEConfig, N: int, E: int,
                 masked: bool) -> Dict[str, Shape]:
    f32, i32 = torch.float32, torch.int32
    inputs = {"feat": ((N, cfg.d_feat), f32), "pos": ((N, 3), f32),
              "edges_src": ((E,), i32), "edges_dst": ((E,), i32),
              "labels": ((N,), i32)}
    if masked:
        inputs["edge_mask"] = ((E,), f32)
        inputs["label_mask"] = ((N,), f32)
    return inputs


def gnn_bundle(name: str, base: M.MACEConfig,
               reduced: bool = False) -> GNNBundle:
    sizes = REDUCED_GNN_SIZES if reduced else GNN_SIZES
    # one config per cell (d_feat / n_out vary per dataset shape)
    cfg_cora = dataclasses.replace(base, d_feat=1433, n_out=7)
    cfg_reddit = dataclasses.replace(base, d_feat=602, n_out=41)
    cfg_products = dataclasses.replace(base, d_feat=100, n_out=47)
    cfg_mol = dataclasses.replace(base, d_feat=0, n_species=32, n_out=1)

    n_max, e_max = NeighborSampler.padded_sizes(*sizes["mb_seeds"])
    n_g, n_n, n_e = sizes["mol"]
    f32, i32 = torch.float32, torch.int32
    mol_inputs = {"species": ((n_g * n_n,), i32), "pos": ((n_g * n_n, 3), f32),
                  "edges_src": ((n_g * n_e,), i32),
                  "edges_dst": ((n_g * n_e,), i32),
                  "graph_of": ((n_g * n_n,), i32), "energy": ((n_g,), f32)}
    specs = {
        "full_graph_sm": GNNCell(
            "full_graph_sm", cfg_cora, M.mace_node_xent,
            _node_inputs(cfg_cora, *sizes["cora"], masked=False)),
        "minibatch_lg": GNNCell(
            "minibatch_lg", cfg_reddit, M.mace_node_xent,
            _node_inputs(cfg_reddit, n_max, e_max, masked=True)),
        "ogb_products": GNNCell(
            "ogb_products", cfg_products, M.mace_node_xent,
            _node_inputs(cfg_products, *sizes["products"], masked=False)),
        "molecule": GNNCell("molecule", cfg_mol, M.mace_energy_mse,
                            mol_inputs),
    }
    return GNNBundle(name=name, config=base, sizes=dict(sizes),
                     cell_specs=specs)
