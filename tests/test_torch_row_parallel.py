"""The recsys family computing on its shards on a mesh
(``repro_torch.distributed.row_parallel``, ``models.recsys``' column
split) on
CPU gloo ranks, against the same steps in one process and against the
JAX package's GSPMD step; and the bag kernel's row window in its plain
version.

Ranks are processes of ``tests/torch_mesh_workers.py rows`` on a
file-store gloo group (no network, ``OMP_NUM_THREADS=1``), in f32, on
(1, 2), (2, 1) and (2, 2) ``("data", "model")`` meshes.  Each mesh runs
two ``Trainer`` steps of DLRM REDUCED (its 1,000-row tables nested over
``("data", "model")``, its 62-, 10- and 14-row ones over ``data``, its
3- and 35-row ones replicated on (2, 2); one grouped bag launch for each
set of axes), two of two-tower REDUCED (every table nested; towers on a
rank's own rows against the gathered items) and two of DIN REDUCED
(tables gathered whole, ``cate`` over ``data`` alone; its MLPs whole,
``recsys.splits_columns``),
each from params whose MLP biases are drawn at random (the init zeroes
them), as ``test_torch_tensor_parallel.py`` draws the QKV bias:

  * the losses and every param within 1e-6 of one process (relative,
    over each leaf's largest value), but DIN's attention-score bias,
    whose gradient is 0 in exact arithmetic (a softmax follows it), held
    to the bound of two AdamW steps;
  * the shapes each rank computed with: a table's block of rows as the
    rules cut it, a DLRM or two-tower MLP weight's columns halved where
    ``model`` divides its width;
  * every param that an axis replicates equal bit for bit across that
    axis, biases included;
  * the lookups' and ``model``'s collectives counted (none of either in
    DIN's steps);
  * DLRM's scores of a batch holding ``chip_smoke.bad_ids``' out-of-range
    ids NaN in one process's rows and one process's elsewhere (``fill``);
  * one table nested over ``("data", "model")`` looked up with ids of
    every rank's rows: the whole lookup's rows bit for bit, NaN for ids
    outside it, and each block's gradient the whole gradient's block.

The (2, 2) DLRM, two-tower and DIN steps are also held to the reference's
jitted step under the bundle's shardings (``tests/torch_mesh_ref.py
rowstep``, 4 forced host devices) within ``test_torch_lm_train.py``'s
tolerances (DIN's attention-score bias to two AdamW steps' bound, as
above).  On a one-rank mesh in the bundles' dtypes the three archs'
steps are the unsharded steps bit for bit.  On the CPU alone: the
windowed grouped bag, blocks cut
mid-table with ids on both sides of each edge, sums to the whole bag
bit for bit at K 1 under both id rules, its blocks' gradients are the
whole gradient's rows, and the window ``(0, V)`` is the unwindowed bag.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import embedding_bags
from repro_torch.kernels.embedding_bag.kernel import (
    embedding_bag_fixed_backward,
)
from repro_torch.models import recsys as RS
from repro_torch.sparse.embedding import embedding_lookup
from repro_torch.train.optim import schedule_lr
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, path_name, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ref import ROW_ARCHS  # noqa: E402
from torch_mesh_workers import recsys_f32  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5    # tests/test_torch_lm_train.py's
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
MESHES = ((1, 2), (2, 1), (2, 2))
ARCHS = {"dlrm": "dlrm-mlperf", "two_tower": "two-tower-retrieval",
         "din": "din"}
BATCH = {"dlrm": 16, "two_tower": 16, "din": 8}
LOOKUP_ROWS, LOOKUP_DIM = 40, 8


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch(name: str, cfg, n: int, rng) -> dict:
    if name == "dlrm":
        b = {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
             "sparse": np.stack([rng.randint(0, r, n) for r in cfg.table_rows],
                                1).astype(np.int32),
             "label": (rng.rand(n) < 0.5).astype(np.float32)}
    elif name == "two_tower":
        b = {"user_id": rng.randint(0, cfg.n_users, n),
             "user_ctx": rng.randint(0, cfg.n_context, n),
             "item_id": rng.randint(0, cfg.n_items, n),
             "item_cat": rng.randint(0, cfg.n_context, n)}
        b = {k: v.astype(np.int32) for k, v in b.items()}
    else:
        S = cfg.seq_len
        b = {"hist_items": rng.randint(0, cfg.n_items, (n, S)),
             "hist_cates": rng.randint(0, cfg.n_cates, (n, S)),
             "hist_mask": (rng.rand(n, S) < 0.7).astype(np.float32),
             "target_item": rng.randint(0, cfg.n_items, n),
             "target_cate": rng.randint(0, cfg.n_cates, n),
             "label": (rng.rand(n) < 0.5).astype(np.float32)}
        b = {k: v.astype(np.float32 if v.dtype == np.float32 else np.int32)
             for k, v in b.items()}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _bad_batch(cfg) -> dict:
    """A DLRM batch of 16 whose rows 0-4 hold, in every table, one of the
    five ids ``chip_smoke.bad_ids`` mixes in (V, -1, -V, -V-1, 2^31-1):
    rows 0, 3 and 4 read outside their tables, rows 1 and 2 wrap."""
    smoke = _smoke()
    b = _batch("dlrm", cfg, 16, np.random.RandomState(11))
    every = smoke.BAG_BAD_EVERY
    for t, V in enumerate(cfg.table_rows):
        five = smoke.bad_ids(torch.zeros(5 * every, dtype=torch.int32),
                             V)[::every]
        b["sparse"][:5, t] = five
    return b


def _lookup_inputs() -> dict:
    rng = np.random.RandomState(12)
    V = LOOKUP_ROWS
    ids = np.array([0, 9, 10, 19, 20, 29, 30, 39, 5, 15, 25, 35, -1, -V, V,
                    -V - 1, 2**31 - 1, 3, 13, 23, 33, 11, 21, 31],
                   dtype=np.int32).reshape(8, 3)
    return {"table": torch.from_numpy(
                rng.randn(V, LOOKUP_DIM).astype(np.float32)),
            "ids": torch.from_numpy(ids),
            "weights": torch.from_numpy(
                rng.randn(8, 3, LOOKUP_DIM).astype(np.float32))}


def _ranks(world: int, data: int, d: Path) -> list:
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"),
         "rows", str(r), str(world), str(d), str(data)], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs) -> None:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks and the reference's step, run side by side:
    (the cases' inputs by mesh, each mesh's results, the reference's
    arrays)."""
    d = tmp_path_factory.mktemp("rows")
    inputs = {}
    for shape in MESHES:
        cases = {}
        for name, arch in ARCHS.items():
            tr = recsys_f32(arch)
            rng = np.random.RandomState(len(name) + 10 * shape[0] + shape[1])
            gen = torch.Generator().manual_seed(len(name))
            params = tr.init(tr.config, gen, masters=True)
            # the MLPs' biases drawn at random where the init zeroes them,
            # as test_torch_tensor_parallel.py draws the QKV bias: each
            # then has a size of its own to be measured against
            for p, b in flatten_with_path(params):
                if path_name(p).endswith("/b"):
                    b.copy_(0.05 * torch.randn(b.shape, generator=gen))
            cases[name] = {
                "arch": arch,
                "params": params,
                "batches": [_batch(name, tr.config, BATCH[name], rng)
                            for _ in range(2)]}
        dlrm = recsys_f32("dlrm-mlperf")
        inputs[shape] = {
            "cases": cases,
            "bad": {"params": cases["dlrm"]["params"],
                    "batch": _bad_batch(dlrm.config)},
            "lookup": _lookup_inputs()}
    ref_in = {}
    for name, arch in ARCHS.items():
        if arch not in ROW_ARCHS:
            continue
        case = inputs[(2, 2)]["cases"][name]
        for p, t in flatten_with_path(case["params"]):
            ref_in[f"{arch}/init/{path_name(p)}"] = t.numpy()
        for i, b in enumerate(case["batches"]):
            for k, v in b.items():
                ref_in[f"{arch}/batch/{i}/{k}"] = v.numpy()
    np.savez(d / "ref_in.npz", **ref_in)
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "rowstep",
         str(d / "ref_in.npz"), str(d / "ref_out.npz")],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = []
    for shape in MESHES:
        sub = d / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        torch.save(inputs[shape], sub / "rows_inputs.pt")
        procs.append((shape, sub, _ranks(shape[0] * shape[1], shape[0],
                                         sub)))
    out = {}
    for shape, sub, ranks in procs:
        _wait(ranks)
        out[shape] = torch.load(sub / "rows_out.pt")
    _wait([ref])
    return inputs, out, dict(np.load(d / "ref_out.npz"))


# DIN's attention-score bias: the softmax over the history cancels any
# shift of the scores, so its gradient is 0 in exact arithmetic and AdamW
# moves it by the sign of rounding noise, in one process and on a mesh
# alike (also on (2, 1), where no column is split): it is held to the
# bound of two AdamW steps instead of 1e-6
NOISE_LEAVES = {"attn/fc2/b"}


def _close(got, want, what: str, bound: float = 0.0) -> None:
    for (p, g), (_, w) in zip(flatten_with_path(got), flatten_with_path(want)):
        g, w = g.double(), w.double()
        if path_name(p) in NOISE_LEAVES:
            assert float((g - w).abs().max()) <= bound, f"{what}/{path_name(p)}"
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= TOL * scale, \
            f"{what}/{path_name(p)}"


def _blocks(rows: int, shape) -> int:
    """The blocks ``RECSYS_RULES`` cuts a table's rows into on a (D, M)
    mesh: ``("data", "model")`` where D * M divides them, else ``data``,
    else ``model``, else none."""
    D, M = shape
    return next(n for n in (D * M, D, M, 1) if rows % n == 0)


CASES = [(s, n) for s in MESHES for n in ARCHS]
IDS = [f"{s[0]}x{s[1]}-{n}" for s, n in CASES]


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_row_parallel_steps_match_one_process(runs, shape, name):
    inputs, out, _ = runs
    case, got = inputs[shape]["cases"][name], out[shape][name]
    tr = recsys_f32(case["arch"])
    one = Trainer(tr.loss_fn(), case["params"],
                  TrainerConfig(opt=tr.opt, log_every=1), device="cpu")
    one.fit(lambda c: case["batches"][c], len(case["batches"]))
    assert len(got["losses"]) == 2
    for g, h in zip(got["losses"], one.history):
        assert abs(g / h["loss"] - 1) <= TOL
    # each of two AdamW steps moves a leaf by at most about 2 lr_t (its
    # normalised first moment), in either run
    lrs = [float(schedule_lr(tr.opt, torch.tensor(t))) for t in (1, 2)]
    _close(got["params"], one.params, f"{shape}/{name}", 4 * sum(lrs))


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_ranks_compute_on_their_blocks_and_columns(runs, shape, name):
    """A table looked up where its rows lie is this rank's block of rows;
    a DLRM or two-tower MLP weight whose width ``model`` divides is this
    rank's columns; DIN's tables and MLPs are gathered whole (no shape
    listed)."""
    inputs, out, _ = runs
    cfg = recsys_f32(ARCHS[name]).config
    full = {path_name(p): tuple(t.shape) for p, t in
            flatten_with_path(inputs[shape]["cases"][name]["params"])}
    want = {}
    for path, (rows, dim) in RS.row_tables(cfg).items():
        want[path] = (rows // _blocks(rows, shape), dim)
    for path, dims in full.items():
        if (RS.splits_columns(cfg) and path.endswith("/w") and "/fc" in path
                and dims[1] % shape[1] == 0):
            want[path] = (dims[0], dims[1] // shape[1])
    assert out[shape][name]["shapes"] == want
    if shape == (2, 2) and name == "dlrm":
        got = out[shape][name]["shapes"]
        sizes = sorted({got[f"tables/t{i}/table"][0] * 4 // r
                        for i, r in enumerate(cfg.table_rows)})
        assert sizes == [1, 2, 4]    # replicated, data alone, nested


@pytest.mark.parametrize("shape,name", CASES, ids=IDS)
def test_replicated_params_are_equal_across_their_axes(runs, shape, name):
    """Every rank's block of each final param: ranks that share their
    coordinates on the axes that shard a leaf hold the same bits of it
    (biases included, which a rank uses only its columns of)."""
    got = runs[1][shape][name]
    names = ("data", "model")
    ranks = got["locals"]
    checked = 0
    for path, axes in got["axes"].items():
        by_key = {}
        for coord, blocks in ranks:
            key = tuple(c for c, n in zip(coord, names) if n in axes)
            if key in by_key:
                assert torch.equal(by_key[key], blocks[path]), (path, coord)
                checked += 1
            by_key[key] = blocks[path]
    assert checked > 0


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_lookups_and_columns_issue_their_collectives(runs, shape):
    """The route is the same on axes of one rank: DLRM's and two-tower's
    lookups and column splits issue collectives; DIN, whose tables and
    MLPs are gathered whole, issues neither."""
    _, out, _ = runs
    for name in ("dlrm", "two_tower"):
        assert out[shape][name]["row_collectives"] > 0, name
        assert out[shape][name]["model_collectives"] > 0, name
    assert out[shape]["din"]["row_collectives"] == 0
    assert out[shape]["din"]["model_collectives"] == 0


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_out_of_range_ids_give_one_process_nan_scores(runs, shape):
    inputs, out, _ = runs
    bad = inputs[shape]["bad"]
    cfg = recsys_f32("dlrm-mlperf").config
    with torch.no_grad():
        want = RS.dlrm_forward(cfg, bad["params"], bad["batch"])
    got = out[shape]["bad_scores"]
    nan = torch.isnan(want)
    assert nan.tolist()[:5] == [True, False, False, True, True]
    assert not nan[5:].any()
    assert torch.equal(torch.isnan(got), nan)
    scale = float(want[~nan].abs().max())
    assert float((got[~nan] - want[~nan]).abs().max()) <= TOL * scale


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_nested_table_lookup_reads_every_block(runs, shape):
    """A (40, 8) table nested over ``("data", "model")``: each rank's
    block starts at (d * M + m) * 40 / (D * M); the ranks' rows are the
    whole lookup's bit for bit (NaN for ids outside the table), and each
    block's gradient is the whole table's gradient's block."""
    inputs, out, _ = runs
    lk = inputs[shape]["lookup"]
    D, M = shape
    table = lk["table"].clone().requires_grad_(True)
    want = embedding_lookup(table, lk["ids"], torch.float32)
    torch.where(torch.isnan(want), 0.0, want * lk["weights"]).sum().backward()
    n = LOOKUP_ROWS // (D * M)
    rows = []
    for coord, first, got, grad in out[shape]["lookup"]:
        assert first == (coord[0] * M + coord[1]) * n
        if coord[1] == 0:
            rows.append(got)
        g = table.grad[first:first + n]
        assert torch.allclose(grad, g, rtol=TOL, atol=0), coord
        assert grad.abs().sum() > 0
    rows = torch.cat(rows)
    assert torch.equal(torch.isnan(rows), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(rows), torch.nan_to_num(want.detach()))
    assert torch.isnan(want).any(dim=-1).sum() == 3


@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_row_step_2x2_matches_the_reference_gspmd_step(runs, arch):
    _, out, want = runs
    name = next(n for n, a in ARCHS.items() if a == arch)
    got = out[(2, 2)][name]
    for g, w in zip(got["losses"], want[f"{arch}/losses"]):
        assert abs(g / w - 1) < LOSS_RTOL
    opt = recsys_f32(arch).opt
    noise = 4 * sum(float(schedule_lr(opt, torch.tensor(t))) for t in (1, 2))
    for p, t in flatten_with_path(got["params"]):
        ref = want[f"{arch}/final/{path_name(p)}"]
        bound = noise if path_name(p) in NOISE_LEAVES else PARAM_TOL
        assert np.abs(ref - t.numpy()).max() < bound, path_name(p)


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(ARCHS))
def test_one_rank_mesh_steps_equal_the_unsharded_steps(one_rank, name):
    """In the bundle's own dtypes (f32 masters, bf16 compute), two steps
    on a (1, 1) mesh through the row-sharded route and the column split
    (every table one block of ``("data", "model")``: DLRM's 26 in one bag
    launch; every collective over the one rank) equal the unsharded
    steps bit for bit, as the card's mesh phase asks at published
    widths."""
    from repro_torch.configs.registry import get_training
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.row_parallel import ROW_COLLECTIVES
    from repro_torch.distributed.sharding import (
        RECSYS_RULES,
        place,
        shard_by_rules,
    )
    from repro_torch.tree import leaves

    tr = get_training(ARCHS[name], reduced=True)
    rng = np.random.RandomState(5)
    batches = [_batch(name, tr.config, 32, rng) for _ in range(2)]
    params = tr.init(tr.config, torch.Generator().manual_seed(0),
                     masters=True)
    tc = TrainerConfig(opt=tr.opt, log_every=1)
    plain = Trainer(tr.loss_fn(), params, tc, device="cpu")
    plain.fit(lambda c: batches[c], 2)
    placed = tree_map(place, params, shard_by_rules(params, one_rank,
                                                    RECSYS_RULES))
    mesh = Trainer(tr.loss_fn(), placed, tc, device="cpu")
    ROW_COLLECTIVES.reset()
    with use_mesh(one_rank):
        mesh.fit(lambda c: batches[c], 2)
    assert [h["loss"] for h in mesh.history] == \
        [h["loss"] for h in plain.history]
    for a, b in zip(leaves(mesh.params), leaves(plain.params)):
        assert torch.equal(a.to_local(), b)
    # a step's lookups: DLRM's one group, two-tower's four tables, each
    # an id gather, a reduce-scatter, an all-reduce and a gradient gather
    want = {"dlrm": 4, "two_tower": 16, "din": 0}[name]
    assert ROW_COLLECTIVES.count == 2 * want


# ------------------------------------------------ the window, plain --
def _cuts(V: int) -> list:
    """Three blocks of a V-row table cut mid-table: (first, rows)."""
    a, b = V // 3 + 1, 2 * V // 3
    return [(0, a), (a, b - a), (b, V - b)]


@pytest.mark.parametrize("rule", ["clip", "fill"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_bags_sum_to_the_whole_bag(rule, K, dtype):
    """Two tables, each cut in three blocks mid-table, looked up by one
    grouped call a block with its window; ids on both sides of every
    edge and out of range.  The blocks' bags sum to the whole bag (bit
    for bit at K 1: one block adds each id, the others 0; within an f32
    ulp of the sum's size at K 8), and the blocks' gradients are the
    whole gradient's rows."""
    rng = np.random.RandomState(K)
    rows = (50, 31)
    tables = [torch.from_numpy(rng.randn(V, 16).astype(np.float32)).to(dtype)
              for V in rows]
    B = 24
    ids = []
    for V in rows:
        edges = [c[0] for c in _cuts(V)[1:]]
        near = [e + o for e in edges for o in (-1, 0)]
        col = rng.randint(0, V, (B, K))
        flat = col.reshape(-1)
        special = near + [0, V - 1, V, -1, -V, -V - 1, 2**31 - 1]
        flat[:len(special)] = special
        ids.append(col)
    ids = torch.from_numpy(np.stack(ids).astype(np.int32))
    weights = torch.from_numpy(rng.rand(2, B, K).astype(np.float32))
    whole = embedding_bags(tables, ids, weights, rule)
    parts = []
    for j in range(3):
        win = [_cuts(V)[j] for V in rows]
        blocks = [t[f:f + n] for t, (f, n) in zip(tables, win)]
        parts.append(embedding_bags(blocks, ids, weights, rule,
                                    windows=[(f, V) for (f, _), V in
                                             zip(win, rows)]))
    total = (parts[0].float() + parts[1].float() + parts[2].float())
    nan = torch.isnan(whole)
    assert torch.equal(torch.isnan(total), nan)
    assert (nan.any() if rule == "fill" else not nan.any())
    if K == 1:
        assert torch.equal(torch.where(nan, 0, total.to(dtype)),
                           torch.where(nan, 0, whole))
    else:
        # each block's sum and the whole sum are rounded once to the
        # tables' dtype: 4 of its steps of the sum of |w * row| bound it
        size = embedding_bags([t.abs() for t in tables], ids, weights,
                              rule, dtype=torch.float32)
        eps = torch.finfo(dtype).eps
        err = (torch.where(nan, 0, total) - torch.where(nan, 0, whole.float()))
        assert bool((err.abs() <= 4 * eps * torch.nan_to_num(size)).all())
    g = torch.from_numpy(rng.randn(B, 16).astype(np.float32))
    for t, V in enumerate(rows):
        full, _ = embedding_bag_fixed_backward(
            g, ids[t], weights[t], (V, 16), torch.float32, id_rule=rule)
        got = torch.cat([embedding_bag_fixed_backward(
            g, ids[t], weights[t], (n, 16), torch.float32, id_rule=rule,
            window=(f, V))[0] for f, n in _cuts(V)])
        assert torch.equal(got, full)


@pytest.mark.parametrize("rule", ["clip", "fill"])
def test_the_whole_window_is_the_unwindowed_bag(rule):
    rng = np.random.RandomState(3)
    rows = (50, 7)
    tables = [torch.from_numpy(rng.randn(V, 16).astype(np.float32))
              for V in rows]
    ids = torch.from_numpy(np.stack([rng.randint(-V - 2, V + 2, (20, 1))
                                     for V in rows]).astype(np.int32))
    w = torch.ones(2, 20, 1)
    a = embedding_bags(tables, ids, w, rule)
    b = embedding_bags(tables, ids, w, rule, windows=[(0, V) for V in rows])
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_a_window_outside_its_table_is_refused():
    t = torch.zeros(10, 16)
    ids = torch.zeros(1, 4, 1, dtype=torch.int32)
    w = torch.ones(1, 4, 1)
    for bad in ((5, 12), (-1, 20), (0, 2**31)):
        with pytest.raises(ValueError):
            embedding_bags([t], ids, w, windows=[bad])
