"""The recsys family serving on its shards on a mesh
(``RecsysBundle.serve_step``: DLRM's and two-tower's tables looked up
where their rows lie, their MLPs on their ``model`` columns, DIN's and
SASRec's tables gathered whole, and a retrieval's top ids merged over
the ranks that split the candidates: ``row_parallel.merge_top_ids``),
on CPU gloo ranks, against the same calls in one process and against
the JAX package's GSPMD cells.

Ranks are processes of ``tests/torch_mesh_workers.py recsysserve`` on a
file-store gloo group (no network, ``OMP_NUM_THREADS=1``), in f32, on
(1, 2), (2, 1) and (2, 2) ``("data", "model")`` meshes, from serving
params drawn by the port (MLP biases drawn at random where the init
zeroes them, as ``test_torch_row_parallel.py`` draws them) and batches
drawn with numpy.  Each of the four archs at REDUCED runs its three
cells: ``serve_p99`` and ``serve_bulk`` on batches split over ``data``;
``retrieval_cand`` on its 1,000 or 500 candidates whole (the cell's own
layout below 1,000,000 rows) and split over ``data`` (a block a data
rank, its top 100 merged); and a tie case, the split retrieval with
the candidate that one process ranks near the 100th copied onto six
positions across the blocks' edge, so that seven equal scores straddle
both the edge and the cut at 100.  Held:

  * each rank's scores within 1e-6 of the one process's largest value
    for its rows (every rank of a batch block returns the same);
  * retrieval ids equal to one process's on every rank, but for
    adjacent pairs whose one-process scores differ by less than that
    tolerance (``chip_smoke.top_swaps``); the tie case's ids exact, the
    tied ones in ascending order (the one process's scores at the seven
    positions asserted equal first);
  * DLRM's and two-tower's calls issue lookup and ``model`` collectives,
    DIN's and SASRec's neither; a split retrieval issues one merge, a
    whole one none.

On (2, 2) every call is also held to the reference's jitted functions
with the params placed by the bundle's shardings and the inputs by the
cells' own layout and with the candidates forced over ``data``
(``tests/torch_mesh_ref.py recsysserve``, 4 forced host devices), at the
same tolerances.  On a one-rank gloo mesh, in the bundles' own dtypes,
every call is the unsharded call bit for bit.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import RECSYS_ARCH_IDS
from repro_torch.tree import flatten_with_path, path_name

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_workers import recsys_bundle_f32, serve_layout  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
MESHES = ((1, 2), (2, 1), (2, 2))
# name -> (cell, candidates split over data)
CALLS = {"serve_p99": ("serve_p99", False),
         "serve_bulk": ("serve_bulk", False),
         "whole": ("retrieval_cand", False),
         "split": ("retrieval_cand", True),
         "ties": ("retrieval_cand", True)}
COPIES = 6       # copies of the tied candidate, half each side of the edge


@functools.lru_cache(maxsize=None)
def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ids(rng, hi: int, *shape) -> np.ndarray:
    return rng.randint(0, hi, shape).astype(np.int32)


def _score_batch(sv, n: int, rng) -> dict:
    cfg = sv.config
    if sv.name == "dlrm-mlperf":
        b = {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
             "sparse": np.stack([_ids(rng, r, n) for r in cfg.table_rows], 1)}
    elif sv.name == "din":
        S = cfg.seq_len
        b = {"hist_items": _ids(rng, cfg.n_items, n, S),
             "hist_cates": _ids(rng, cfg.n_cates, n, S),
             "hist_mask": (rng.rand(n, S) < 0.7).astype(np.float32),
             "target_item": _ids(rng, cfg.n_items, n),
             "target_cate": _ids(rng, cfg.n_cates, n)}
    elif sv.name == "sasrec":
        b = {"seq": _ids(rng, cfg.n_items, n, cfg.seq_len),
             "candidates": _ids(rng, cfg.n_items, n, sv.serve_candidates)}
    else:
        b = {"user_id": _ids(rng, cfg.n_users, n),
             "user_ctx": _ids(rng, cfg.n_context, n),
             "item_id": _ids(rng, cfg.n_items, n),
             "item_cat": _ids(rng, cfg.n_context, n)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _retrieval_batch(sv, rng) -> dict:
    cfg, n = sv.config, sv.n_candidates
    if sv.name == "dlrm-mlperf":
        b = {k: v.numpy() for k, v in _score_batch(sv, 1, rng).items()}
        b["candidates"] = _ids(rng, cfg.table_rows[0], n)
    elif sv.name == "din":
        b = {k: v.numpy() for k, v in _score_batch(sv, 1, rng).items()
             if k.startswith("hist")}
        b["candidates"] = _ids(rng, cfg.n_items, n)
        b["candidate_cates"] = _ids(rng, cfg.n_cates, n)
    elif sv.name == "sasrec":
        b = {"seq": _ids(rng, cfg.n_items, 1, cfg.seq_len),
             "candidates": _ids(rng, cfg.n_items, n)}
    else:
        b = {"user_id": _ids(rng, cfg.n_users, 1),
             "user_ctx": _ids(rng, cfg.n_context, 1),
             "candidate_embs": rng.randn(n, cfg.tower_mlp[-1]).astype(
                 np.float32)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rows(batch: dict) -> list:
    """The inputs that hold one row a candidate."""
    key = "candidates" if "candidates" in batch else "candidate_embs"
    n = batch[key].shape[0]
    return [k for k, v in batch.items() if v.dim() and v.shape[0] == n]


def _tied(sv, params, batch: dict) -> tuple:
    """``batch`` with a candidate copied onto COPIES positions centred on
    the candidates' middle (the blocks' edge on two data ranks), and the
    positions of the tied candidates, the original first.  The one
    copied is the one that one process ranks at 94-99 among the others
    (the one whose score stands furthest from its neighbours'), so that
    the seven tied scores take ranks 94-99 to 100-105."""
    with torch.no_grad():
        scores = sv.candidate_scores(sv.config, params, batch).double()
    n = scores.shape[0]
    copies = [n // 2 - COPIES // 2 + j for j in range(COPIES)]
    scores[copies] = float("-inf")
    order = torch.sort(scores, descending=True, stable=True).indices
    s = scores[order]

    def gap(i):
        return min(float(s[i - 1] - s[i]), float(s[i] - s[i + 1]))

    src = int(order[max(range(94, 100), key=gap)])
    out = {k: v.clone() for k, v in batch.items()}
    for k in _rows(batch):
        out[k][copies] = batch[k][src]
    return out, [src] + copies


def _inputs(arch: str, shape) -> dict:
    bundle = recsys_bundle_f32(arch)
    sv = bundle.serving
    gen = torch.Generator().manual_seed(len(arch))
    params = bundle.init(gen, masters=False)
    for p, b in flatten_with_path(params):
        if path_name(p).endswith("/b"):
            b.copy_(0.05 * torch.randn(b.shape, generator=gen))
    rng = np.random.RandomState(len(arch) + 10 * shape[0] + shape[1])
    retrieval = _retrieval_batch(sv, rng)
    ties, tied = _tied(sv, params, _retrieval_batch(sv, rng))
    batches = {"serve_p99": _score_batch(sv, sv.batch_sizes["serve_p99"],
                                         rng),
               "serve_bulk": _score_batch(sv, sv.batch_sizes["serve_bulk"],
                                          rng),
               "whole": retrieval, "split": retrieval, "ties": ties}
    return {"params": params, "tied": tied,
            "calls": {name: (cell, batches[name], split)
                      for name, (cell, split) in CALLS.items()}}


def _ranks(world: int, data: int, d: Path) -> list:
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"),
         "recsysserve", str(r), str(world), str(d), str(data)], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs) -> None:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks and the reference's cells, run side by side:
    (the inputs by mesh and arch, each mesh's per-arch per-rank results,
    the reference's arrays)."""
    d = tmp_path_factory.mktemp("recsysserve")
    inputs = {shape: {arch: _inputs(arch, shape) for arch in RECSYS_ARCH_IDS}
              for shape in MESHES}
    ref_in = {}
    for arch, case in inputs[(2, 2)].items():
        for p, t in flatten_with_path(case["params"]):
            ref_in[f"{arch}/init/{path_name(p)}"] = t.numpy()
        ref_in[f"{arch}/calls"] = np.array(json.dumps(
            {name: [cell, split]
             for name, (cell, _, split) in case["calls"].items()}))
        for name, (_, batch, _) in case["calls"].items():
            for k, v in batch.items():
                ref_in[f"{arch}/{name}/{k}"] = v.numpy()
    np.savez(d / "ref_in.npz", **ref_in)
    procs = [(None, [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "recsysserve", str(d / "ref_in.npz"), str(d / "ref_out.npz")],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])]
    for shape in MESHES:
        sub = d / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        torch.save({arch: {"params": c["params"], "calls": c["calls"]}
                    for arch, c in inputs[shape].items()},
                   sub / "recsysserve_inputs.pt")
        procs.append((shape, _ranks(shape[0] * shape[1], shape[0], sub)))
    out = {}
    for shape, ranks in procs:
        _wait(ranks)
        if shape is not None:
            sub = d / f"{shape[0]}x{shape[1]}"
            out[shape] = torch.load(sub / "recsysserve_out.pt")
    return inputs, out, dict(np.load(d / "ref_out.npz"))


def _one_process(arch: str, case: dict) -> dict:
    """Each call's output with no mesh, and each retrieval's candidate
    scores."""
    bundle = recsys_bundle_f32(arch)
    sv = bundle.serving
    out = {}
    for name, (cell, batch, _) in case["calls"].items():
        out[name] = bundle.serve_step(cell)(case["params"], batch)
        if cell == "retrieval_cand":
            with torch.no_grad():
                out[f"{name}_scores"] = sv.candidate_scores(
                    sv.config, case["params"], batch)
    return out


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _same_ids(got, want, scores, what: str) -> None:
    got, want = list(map(int, got)), list(map(int, want))
    tol = TOL * float(scores.abs().max())
    assert _smoke().top_swaps(got, want, scores.double(), tol) is not None, \
        f"{what}: {got[:12]} vs {want[:12]}"


CASES = [(s, a) for s in MESHES for a in RECSYS_ARCH_IDS]
IDS = [f"{s[0]}x{s[1]}-{a}" for s, a in CASES]


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_serve_calls_match_one_process(runs, shape, arch):
    inputs, out, _ = runs
    case, got = inputs[shape][arch], out[shape][arch]
    want = _one_process(arch, case)
    data = shape[0]
    for coord, calls in got:
        for name, (cell, batch, _) in case["calls"].items():
            if name == "ties":      # held exactly below
                continue
            r = calls[name]["out"]
            what = f"{arch} {shape} {coord} {name}"
            if cell == "retrieval_cand":
                assert r.shape == want[name].shape, what
                _same_ids(r, want[name], want[f"{name}_scores"], what)
                continue
            b = want[name].shape[0] // data
            rows = slice(coord[0] * b, (coord[0] + 1) * b)
            assert r.shape == want[name][rows].shape, what
            _close(r, want[name][rows], what)
    # every rank returns the same ids
    for name, (cell, _, _) in case["calls"].items():
        if cell == "retrieval_cand":
            first = got[0][1][name]["out"]
            assert all(torch.equal(c[name]["out"], first) for _, c in got)


def _blockwise_top(arch: str, case: dict, blocks: int) -> list:
    """The top 100 (stable: the lower id first among equal scores) of
    the tie batch's candidates scored a block at a time in one process,
    as DIN's and SASRec's route on a mesh scores them (tables and MLPs
    whole)."""
    sv = recsys_bundle_f32(arch).serving
    batch = case["calls"]["ties"][1]
    rows = _rows(batch)
    n = batch[rows[0]].shape[0] // blocks
    with torch.no_grad():
        scores = torch.cat([sv.candidate_scores(sv.config, case["params"], {
            k: v[i * n:(i + 1) * n] if k in rows else v
            for k, v in batch.items()}) for i in range(blocks)])
    return torch.sort(scores, descending=True,
                      stable=True).indices[:100].tolist()


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_ties_across_the_block_edge_keep_the_lower_id_first(runs, shape,
                                                            arch):
    """Seven equal scores, three of them in the first data block and four
    in the second, with the cut at 100 among them: DLRM's and
    two-tower's ids are exactly the one process's, the tied ones
    ascending.  DIN's and SASRec's forwards on the CPU score one
    candidate in different last bits at different positions of a batch
    or in batches of other sizes (DIN's seven are not all equal in one
    process, SASRec's not across the blocks); their route scores each
    block as one process does, so their ids are held exactly to the top
    100 of their blocks' one-process scores, the merge's ties included."""
    inputs, out, _ = runs
    case = inputs[shape][arch]
    tied = case["tied"]
    if arch in ("din", "sasrec"):
        ids = _blockwise_top(arch, case, shape[0])
    else:
        want = _one_process(arch, case)
        scores = want["ties_scores"]
        assert len({float(scores[i]) for i in tied}) == 1   # exact ties
        ids = want["ties"].tolist()
        kept = [i for i in ids if i in tied]
        assert kept == sorted(tied)[:len(kept)] and 0 < len(kept) < 7
    for coord, calls in out[shape][arch]:
        assert calls["ties"]["out"].tolist() == ids, (arch, shape, coord)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_serve_route_issues_its_collectives(runs, shape):
    """DLRM's and two-tower's lookups and column splits issue collectives
    on axes of one rank too; DIN and SASRec (tables gathered whole, no
    MLP split) issue neither; a split retrieval merges once, a whole one
    not at all."""
    _, out, _ = runs
    for arch in RECSYS_ARCH_IDS:
        for _, calls in out[shape][arch]:
            for name, (cell, split) in CALLS.items():
                c = calls[name]
                routed = arch in ("dlrm-mlperf", "two-tower-retrieval")
                assert (c["rows"] > 0) == routed, (arch, name, c)
                assert (c["model"] > 0) == routed, (arch, name, c)
                assert c["merge"] == int(split), (arch, name, c)


@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_serve_2x2_matches_the_reference_gspmd_cells(runs, arch):
    """The (2, 2) ranks against the JAX package's jitted functions under
    the bundle's shardings, the candidates whole (the cell's layout at
    REDUCED) and forced over ``data``."""
    inputs, out, ref = runs
    case = inputs[(2, 2)][arch]
    mine = _one_process(arch, case)
    got = out[(2, 2)][arch]
    for name, (cell, _, _) in case["calls"].items():
        want = torch.from_numpy(ref[f"{arch}/{name}"])
        if cell == "retrieval_cand":
            for coord, calls in got:
                ids, ref_ids = calls[name]["out"], want
                if name == "ties":
                    # the reference need not score the seven copies
                    # equally to the last bit either: the same count of
                    # them kept, the other ids as the rule above has them
                    tied = case["tied"]
                    assert sum(int(i) in tied for i in ids) == sum(
                        int(i) in tied for i in want), (arch, coord)
                    ids, ref_ids = ([int(i) for i in x if int(i) not in tied]
                                    for x in (ids, want))
                _same_ids(ids, ref_ids, mine[f"{name}_scores"],
                          f"{arch} {coord} {name}")
            continue
        scores = torch.cat([c[name]["out"] for coord, c in sorted(
            got, key=lambda x: x[0]) if coord[1] == 0])
        _close(scores, want, f"{arch} {name}")


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


@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_one_rank_mesh_serve_is_the_unsharded_call(one_rank, arch):
    """In the bundle's own dtypes (bf16 serving weights), every call on a
    (1, 1) mesh, through the route and its one-rank collectives, with
    the candidates whole and split, equals the call without a mesh bit
    for bit, as the card's mesh serve check asks at published widths;
    placing the weights copies nothing."""
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.sharding import place
    from repro_torch.tree import leaves, tree_map

    bundle = get_bundle(arch, reduced=True)
    sv = bundle.serving
    params = bundle.init(torch.Generator().manual_seed(0), masters=False)
    placed = tree_map(place, params, bundle.param_shardings(one_rank))
    assert all(a.to_local().data_ptr() == b.data_ptr()
               for a, b in zip(leaves(placed), leaves(params)))
    rng = np.random.RandomState(3)
    retrieval = _retrieval_batch(sv, rng)
    for name, (cell, split) in CALLS.items():
        batch = (retrieval if cell == "retrieval_cand"
                 else _score_batch(sv, sv.batch_sizes[cell], rng))
        step = bundle.serve_step(cell)
        layout = serve_layout(bundle, cell, batch, one_rank, split)
        got = step(placed, {k: place(v, layout[k]) for k, v in batch.items()})
        assert torch.equal(got, step(params, batch)), (arch, name)


def test_a_serve_step_refuses_candidates_split_over_model(one_rank):
    from repro_torch.configs.registry import get_bundle
    from repro_torch.distributed.sharding import NamedSharding, P, place
    from repro_torch.tree import tree_map

    bundle = get_bundle("sasrec", reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0), masters=False)
    placed = tree_map(place, params, bundle.param_shardings(one_rank))
    batch = _retrieval_batch(bundle.serving, np.random.RandomState(0))
    batch = {"seq": batch["seq"],
             "candidates": place(batch["candidates"],
                                 NamedSharding(one_rank, P("model")))}
    with pytest.raises(ValueError, match="over the batch axes"):
        bundle.serve_step("retrieval_cand")(placed, batch)
    with pytest.raises(ValueError, match="not a serve cell"):
        bundle.serve_step("train_batch")
