"""The GNN family computing on its batch shards on a mesh
(``repro_torch.distributed.graph_parallel``, ``models.mace`` on a rank's
node rows and edge block) on CPU gloo ranks, against the same step in
one process and against the JAX package's GSPMD step.

Ranks are processes of ``tests/torch_mesh_workers.py gnn`` on a
file-store gloo group (no network, ``OMP_NUM_THREADS=1``), in f32, each
case one ``Trainer`` step of a REDUCED MACE cell with the bundle's
AdamW:

  * on (1, 2), (2, 1) and (2, 2) ``("data", "model")`` meshes: Cora,
    the sampled cell (masked) and the molecules at their REDUCED sizes;
    two mixed layouts, nodes split with the edges whole (64 nodes, 301
    edges) and edges split with the nodes whole (63 nodes, 300 edges);
    and three molecules of 10 nodes whose 48 edges are shuffled, so a
    graph's nodes and its edges straddle the rank blocks (the energies,
    3, whole);
  * on a 4-rank ``("pod", "data")`` mesh, each batch placed by the
    cell's ``input_sharding`` as the dry run sanitizes it: 130 nodes
    over ``pod`` alone with 520 edges over both axes, 132 nodes over
    both with 518 edges over ``pod`` alone, and the molecules over both;
  * the losses within 1e-6 relative, the step's gradient (the ranks'
    shares summed) within 1e-6 of each leaf's largest value, and every
    param within 1e-6 of its largest value of one process, but the
    elements whose clipped gradient is below 1e-7 (``FLOOR``) and not
    0: AdamW's first step moves an element by lr g / (|g| + 1e-8),
    which there turns the gradient's rounding noise (1e-10 for a sum of
    terms of 1e-3 in another order) into a move of up to 1e-5 relative,
    so those (many of MACE's first-layer w2 and w3 at REDUCED) are held
    to the step's own bound, 2 lr, beside their gradients held above;
    where each rank's blocks lie, as the
    layout's axes cut the rows; the route's collectives
    (``GRAPH_COLLECTIVES``) per step, worked out from the layers;
  * ``gather_nodes`` and ``sum_to_owners`` of a test function on the
    cases' blocks: the whole states gathered bit for bit, the owners'
    sums, and the shares of the gradient summing to the whole gradient;
  * on (2, 2) the three cells, placed by the cell's ``input_sharding``,
    against the reference's jitted train step from the same params and
    batch (``tests/torch_mesh_ref.py gnnstep``, 4 forced host devices)
    within ``test_torch_row_parallel.py``'s tolerances (the elements
    below ``FLOOR`` as above);
  * on a one-rank mesh the three cells' steps bit for bit against the
    same steps without a mesh.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_bundle
from repro_torch.train.optim import schedule_lr
from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad
from repro_torch.tree import flatten_with_path, leaves, path_name

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gnn_cases import mol_batch, node_batch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6                           # test_torch_mesh_train.py's
LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5    # test_torch_row_parallel.py's
FLOOR = 1e-7     # a clipped gradient below this: AdamW's eps (1e-8) shows
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
DATA_AXES = ("data", "model")
POD_AXES = ("pod", "data")
MESHES = {"1x2": ((1, 2), DATA_AXES), "2x1": ((2, 1), DATA_AXES),
          "2x2": ((2, 2), DATA_AXES), "pod": ((2, 2), POD_AXES),
          "one": ((1, 1), DATA_AXES)}
CELLS = ("full_graph_sm", "minibatch_lg", "molecule")
BUNDLE = get_bundle("mace", reduced=True)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _node_case(cell: str, n: int, e: int, seed: int, masked=False) -> dict:
    cfg = BUNDLE.cell_specs[cell].config
    g = node_batch(n, e, cfg.d_feat, cfg.n_out, np.random.RandomState(seed),
                   masked)
    return {k: torch.from_numpy(v) for k, v in g.items()}


def _mol_case(n_g: int, n_n: int, n_e: int, seed: int, shuffle=False):
    rng = np.random.RandomState(seed)
    b = mol_batch(n_g, n_n, n_e, rng)
    if shuffle:
        order = rng.permutation(n_g * n_e)
        b["edges_src"], b["edges_dst"] = (b["edges_src"][order],
                                          b["edges_dst"][order])
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _cell_batch(cell: str, seed: int) -> dict:
    """A batch of the REDUCED cell's own sizes."""
    if cell == "molecule":
        return _mol_case(*BUNDLE.sizes["mol"], seed)
    spec = BUNDLE.cell_specs[cell]
    n, e = spec.inputs["feat"][0][0], spec.inputs["edges_src"][0][0]
    return _node_case(cell, n, e, seed, masked=cell == "minibatch_lg")


def _function(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(n, 3).astype(np.float32))
            for k in ("h", "w", "q")}


def _cases(mesh: str) -> dict:
    """name -> (cell, batch, layout: "trainer" (``shard_batch``) or
    "cell" (``input_sharding``))."""
    if mesh == "pod":
        return {"pod_nodes": ("full_graph_sm",
                              _node_case("full_graph_sm", 130, 520, 21),
                              "cell"),
                "pod_edges": ("full_graph_sm",
                              _node_case("full_graph_sm", 132, 518, 22),
                              "cell"),
                "molecule": ("molecule", _cell_batch("molecule", 23),
                             "cell")}
    layout = "cell" if mesh == "2x2" else "trainer"
    cases = {c: (c, _cell_batch(c, 10 + i), layout)
             for i, c in enumerate(CELLS)}
    if mesh == "one":
        return cases
    cases.update({
        "nodes_split": ("full_graph_sm",
                        _node_case("full_graph_sm", 64, 301, 14), "trainer"),
        "edges_split": ("full_graph_sm",
                        _node_case("full_graph_sm", 63, 300, 15), "trainer"),
        "straddle": ("molecule", _mol_case(3, 10, 16, 16, shuffle=True),
                     "trainer")})
    return cases


def _params(cell: str, seed: int) -> dict:
    """The cell's init with every bias drawn at random (the init zeroes
    them), so each has a size of its own to be measured against."""
    gen = torch.Generator().manual_seed(seed)
    params = BUNDLE.cell_specs[cell].init(gen)
    for p, b in flatten_with_path(params):
        if path_name(p).endswith("/b"):
            b.copy_(0.05 * torch.randn(b.shape, generator=gen))
    return params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks and the reference's step, run side by side:
    (each mesh's inputs, each mesh's results, the reference's arrays)."""
    d = tmp_path_factory.mktemp("gnn")
    inputs, procs = {}, []
    for mesh, (shape, axes) in MESHES.items():
        cases = {}
        for i, (name, (cell, batch, layout)) in enumerate(
                _cases(mesh).items()):
            case = {"cell": cell, "batch": batch, "layout": layout,
                    "params": _params(cell, i), "plain": mesh == "one"}
            if cell != "molecule":
                case["function"] = _function(batch["pos"].shape[0], 30 + i)
            cases[name] = case
        inputs[mesh] = {"mesh": (shape, axes), "cases": cases}
        sub = d / mesh
        sub.mkdir()
        torch.save(inputs[mesh], sub / "gnn_inputs.pt")
        world = shape[0] * shape[1]
        procs.append((mesh, sub, [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"),
             "gnn", str(r), str(world), str(sub)], env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]))
    ref_in = {}
    for cell in CELLS:
        case = inputs["2x2"]["cases"][cell]
        for p, t in flatten_with_path(case["params"]):
            ref_in[f"{cell}/init/{path_name(p)}"] = t.numpy()
        for k, v in case["batch"].items():
            ref_in[f"{cell}/batch/{k}"] = v.numpy()
    np.savez(d / "ref_in.npz", **ref_in)
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "gnnstep",
         str(d / "ref_in.npz"), str(d / "ref_out.npz")],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for mesh, sub, ranks in procs:
        _wait(ranks)
        out[mesh] = torch.load(sub / "gnn_out.pt")
    _wait([ref])
    return inputs, out, dict(np.load(d / "ref_out.npz"))


def _wait(procs) -> None:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def _floored(case: dict) -> list:
    """Per leaf, where the one-process step's clipped gradient is below
    FLOOR but not 0 (a species no molecule holds, exactly), and the
    bound of an element's move there (2 lr of step 1)."""
    spec = BUNDLE.cell_specs[case["cell"]]
    _, grads = value_and_grad(spec.loss_fn(), case["params"], case["batch"])
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in leaves(grads))))
    clip = min(1.0, spec.opt.clip_norm / max(norm, 1e-9))
    below = [((g * clip).abs() < FLOOR) & (g != 0) for g in leaves(grads)]
    return below, 2 * float(schedule_lr(spec.opt, torch.tensor(1))), grads


def _close(got, want, what: str, floored, tol: float = TOL) -> None:
    below, bound, _ = floored
    for (p, g), (_, w), low in zip(flatten_with_path(got),
                                   flatten_with_path(want), below):
        g, w = torch.as_tensor(g).double(), torch.as_tensor(w).double()
        scale = max(float(w.abs().max()), 1e-30)
        err = (g - w).abs()
        assert float(torch.where(low, 0.0, err).max()) <= tol * scale, \
            f"{what}/{path_name(p)}"
        assert float(torch.where(low, err, 0.0).max()) <= bound, \
            f"{what}/{path_name(p)}"


def _fit(shape, axes, rows: int, layout: str) -> tuple:
    """The axes that split ``rows`` rows: the trainer's rule (every batch
    axis, or none) or the cell's sanitized one (the whole tuple, a
    prefix, then each single axis)."""
    sizes = dict(zip(axes, shape))
    batch = tuple(a for a in axes if a in ("pod", "data"))
    whole = int(np.prod([sizes[a] for a in batch]))
    if layout == "trainer":
        return batch if rows % whole == 0 else ()
    for cand in [batch[:k] for k in range(len(batch), 0, -1)] + [
            (a,) for a in batch]:
        if rows % int(np.prod([sizes[a] for a in cand])) == 0:
            return cand
    return ()


def _layout(mesh: str, case: dict) -> tuple:
    shape, axes = MESHES[mesh]
    b = case["batch"]
    return (_fit(shape, axes, b["pos"].shape[0], case["layout"]),
            _fit(shape, axes, b["edges_src"].shape[0], case["layout"]))


RUN_CASES = [(m, n) for m in ("1x2", "2x1", "2x2", "pod")
             for n in _cases(m)]
RUN_IDS = [f"{m}-{n}" for m, n in RUN_CASES]


@pytest.mark.parametrize("mesh,name", RUN_CASES, ids=RUN_IDS)
def test_gnn_steps_on_shards_match_one_process(runs, mesh, name):
    inputs, out = runs[0], runs[1]
    case, got = inputs[mesh]["cases"][name], out[mesh][name]
    spec = BUNDLE.cell_specs[case["cell"]]
    one = Trainer(spec.loss_fn(), case["params"],
                  TrainerConfig(opt=spec.opt, log_every=1), device="cpu")
    one.fit(lambda c: case["batch"], 1)
    assert abs(got["loss"] / one.history[0]["loss"] - 1) <= TOL
    floored = _floored(case)
    for (p, g), w in zip(flatten_with_path(got["grads"]), leaves(floored[2])):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= TOL * scale, \
            f"{mesh}/{name}/grad/{path_name(p)}"
    _close(got["params"], one.params, f"{mesh}/{name}", floored)


@pytest.mark.parametrize("mesh,name", RUN_CASES, ids=RUN_IDS)
def test_ranks_hold_their_node_and_edge_blocks(runs, mesh, name):
    """Each rank's node rows and edge block are the blocks its layout's
    axes cut, the outermost axis major; ranks off those axes hold the
    same blocks."""
    inputs, out = runs[0], runs[1]
    case, got = inputs[mesh]["cases"][name], out[mesh][name]
    shape, axes = MESHES[mesh]
    want = _layout(mesh, case)
    assert got["axes"] == want
    rows = (case["batch"]["pos"].shape[0], case["batch"]["edges_src"].shape[0])
    for coord, *blocks in got["blocks"]:
        for (first, n), split, total in zip(blocks, want, rows):
            index, count = 0, 1
            for a, c, size in zip(axes, coord, shape):
                if a in split:
                    index, count = index * size + c, count * size
            assert (first, n) == (index * total // count, total // count)


@pytest.mark.parametrize("mesh,name", RUN_CASES, ids=RUN_IDS)
def test_route_issues_the_collectives_of_its_layers(runs, mesh, name):
    """Per step: the positions gathered once over the node axes; per
    layer, forward and recomputed, the states gathered (one a node axis)
    and summed into their owners (one an edge axis), and in the backward
    both transposed; a molecule's energies summed over the node axes
    and back (``chip_smoke.graph_route_count``, which the card's check
    expects)."""
    inputs, out = runs[0], runs[1]
    case = inputs[mesh]["cases"][name]
    nodes, edges = (len(a) for a in _layout(mesh, case))
    layers = BUNDLE.cell_specs[case["cell"]].config.n_layers
    want = nodes + 3 * layers * (nodes + edges)
    if case["cell"] == "molecule":
        want += 2 * nodes
    assert out[mesh][name]["collectives"] == want
    assert _smoke().graph_route_count(layers, nodes, edges,
                                      case["cell"] == "molecule") == want


FUNCTION_CASES = [(m, n) for m, n in RUN_CASES
                  if _cases(m)[n][0] != "molecule"]


@pytest.mark.parametrize("mesh,name", FUNCTION_CASES,
                         ids=[f"{m}-{n}" for m, n in FUNCTION_CASES])
def test_gather_nodes_and_sum_to_owners_hold_the_share_rule(runs, mesh,
                                                            name):
    inputs, out = runs[0], runs[1]
    case = inputs[mesh]["cases"][name]
    f, got = case["function"], out[mesh][name]["function"]
    dst = case["batch"]["edges_dst"].long()
    n_all = f["h"].shape[0]
    deg = torch.zeros(n_all).index_add_(0, dst, torch.ones(dst.shape[0]))
    y_all = deg[:, None] * f["h"] * f["w"]
    grad = torch.zeros(n_all, 3)
    for first, z, y, g in got:
        assert torch.equal(z, f["h"])
        n = y.shape[0]
        assert torch.allclose(y, y_all[first:first + n], rtol=1e-6,
                              atol=1e-6)
        grad[first:first + n] += g
    assert torch.allclose(grad, deg[:, None] * f["w"] * f["q"], rtol=1e-6,
                          atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_gnn_step_on_2x2_matches_reference_gspmd_step(runs, cell):
    inputs, out, ref = runs
    got = out["2x2"][cell]
    assert abs(got["loss"] / float(ref[f"{cell}/loss"]) - 1) <= LOSS_RTOL
    want = [torch.from_numpy(ref[f"{cell}/final/{path_name(p)}"])
            for p, _ in flatten_with_path(got["params"])]
    _close(got["params"], want, f"2x2/{cell}",
           _floored(inputs["2x2"]["cases"][cell]), PARAM_TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_one_rank_mesh_step_is_the_unsharded_step_bit_for_bit(runs, cell):
    got = runs[1]["one"][cell]
    assert got["loss"] == got["plain"]["loss"]
    for (p, a), (_, b) in zip(flatten_with_path(got["params"]),
                              flatten_with_path(got["plain"]["params"])):
        assert torch.equal(a, b), path_name(p)
