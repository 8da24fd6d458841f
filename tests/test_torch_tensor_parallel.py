"""The LM family computing on its ``model`` shards (tensor and expert
parallelism, ``repro_torch.distributed.tensor_parallel``) on CPU gloo
ranks, against the same steps in one process and against the JAX
package's GSPMD step.

Ranks are processes of ``tests/torch_mesh_workers.py tp`` on a file-store
gloo group (no network, ``OMP_NUM_THREADS=1``), in f32.  On a (1, 2)
``("data", "model")`` mesh: granite-3-2b REDUCED, qwen1.5-4b REDUCED
(QKV bias, drawn at random where ``init_params`` zeroes it, so that it
shapes the forward and each bias leaf has a size of its own to be
measured against; an untied unembedding), granite with one K/V head (K/V whole,
the query heads split), moonshot-v1-16b-a3b REDUCED (4 experts a rank,
the shared expert split) and the same with ``dispatch="sort"``; on a
(2, 2) mesh granite, from the reference's initial params, and moonshot.
Each case: two ``Trainer`` steps in two microbatches, the loss and every
param within 1e-6 of one process (relative, over each leaf's largest
value), the shapes each rank computed with (``wq``'s columns, ``wo``'s
rows, the MLP's, the experts, the vocabulary rows: halved), a count of
``model`` collectives above 0 (no case passes through a whole gather),
and MoE's drops summed over the batch ranks equal to one process's.  The
(2, 2) granite case is also held to the reference's jitted step on a
(2, 2) mesh of forced host devices (``tests/torch_mesh_ref.py tpstep``)
within ``tests/test_torch_lm_train.py``'s tolerances.  On both meshes the
step's gradient reductions, ``compress_tree`` and ``global_norm``, are
held on a tree holding a ``model`` shard to the same of the whole tree.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import transformer_params_from_jax
from repro_torch.launch.train import synth_lm_batches
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, path_name

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_workers import (  # noqa: E402
    MOE_ARCH,
    lm_bundle_f32,
    reduction_tree,
)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
LOSS_RTOL, PARAM_TOL = 1e-6, 1e-5    # tests/test_torch_lm_train.py's
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
MICRO = 2

# case: (mesh, arch, config changes, sequence length)
CASES = {
    "granite_1x2": ((1, 2), "granite-3-2b", {}, 32),
    "qwen_1x2": ((1, 2), "qwen1.5-4b", {}, 32),
    "granite_kv1_1x2": ((1, 2), "granite-3-2b", {"n_kv_heads": 1}, 32),
    "moonshot_1x2": ((1, 2), MOE_ARCH, {}, 64),
    "moonshot_sort_1x2": ((1, 2), MOE_ARCH, {"dispatch": "sort"}, 64),
    "granite_2x2": ((2, 2), "granite-3-2b", {}, 32),
    "moonshot_2x2": ((2, 2), MOE_ARCH, {}, 64),
}
# the leaves each case computes on as halves, by the dimension split
SPLIT = {"block/wq/w": -1, "block/wo/w": -2, "block/mlp/wg/w": -1,
         "block/mlp/wu/w": -1, "block/mlp/wd/w": -2, "embed/table": -2}
SPLIT_KV = {"block/wk/w": -1, "block/wv/w": -1}
SPLIT_MOE = {"block/wq/w": -1, "block/wo/w": -2, "embed/table": -2,
             "block/moe/wg": -3, "block/moe/wu": -3, "block/moe/wd": -3,
             "block/moe/shared/wg": -1, "block/moe/shared/wu": -1,
             "block/moe/shared/wd": -2}
EXPECT = {
    "granite_1x2": {**SPLIT, **SPLIT_KV},
    "qwen_1x2": {**SPLIT, **SPLIT_KV, "block/wq/b": -1, "block/wk/b": -1,
                 "block/wv/b": -1, "unembed/w": -1},
    "granite_kv1_1x2": SPLIT,
    "moonshot_1x2": {**SPLIT_MOE, **SPLIT_KV},
    "moonshot_sort_1x2": {**SPLIT_MOE, **SPLIT_KV},
    "granite_2x2": {**SPLIT, **SPLIT_KV},
    "moonshot_2x2": {**SPLIT_MOE, **SPLIT_KV},
}


def _batches(vocab: int, seq: int):
    """Two batches of 8 x ``seq``; some labels are -1, more in the first
    half of each microbatch, so the batch ranks' valid counts differ."""
    out = []
    for c in range(2):
        b = {k: torch.from_numpy(v)
             for k, v in synth_lm_batches(vocab, 8, seq)(c).items()}
        b["labels"][0, :20] = -1
        b["labels"][4, 5:25] = -1
        out.append(b)
    return out


def _ranks(world: int, data: int, d: Path) -> list:
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"), "tp",
         str(r), str(world), str(d), str(data)], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs) -> None:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks and the reference's step, run side by side:
    (the cases' inputs, each case's results, the reference's arrays)."""
    d = tmp_path_factory.mktemp("tp")
    cases = {}
    for name, ((data, model), arch, changes, seq) in CASES.items():
        bundle = lm_bundle_f32(arch, **changes)
        gen = torch.Generator().manual_seed(len(name))
        params = bundle.init(gen)
        for w in ("wq", "wk", "wv"):
            if "b" in params["block"][w]:
                b = params["block"][w]["b"]
                b.copy_(0.05 * torch.randn(b.shape, generator=gen))
        cases[name] = {
            "arch": arch, "changes": changes, "microbatches": MICRO,
            "params": params, "batches": _batches(bundle.config.vocab, seq)}
    batches = cases["granite_2x2"]["batches"]
    np.savez(d / "ref_in.npz",
             **{k: np.stack([b[k].numpy() for b in batches])
                for k in ("tokens", "labels")})
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "tpstep",
         str(d / "ref_in.npz"), str(d / "ref_out.npz")],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _wait([ref])
    want = dict(np.load(d / "ref_out.npz"))
    # the (2, 2) granite case starts from the reference's params
    cfg = lm_bundle_f32().config
    init = {}
    for k, v in want.items():
        if k.startswith("init/"):
            node = init
            *path, leaf = k[len("init/"):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    cases["granite_2x2"]["params"] = transformer_params_from_jax(
        cfg, init, "cpu", masters=True)
    procs = []
    for shape in sorted({m for m, *_ in CASES.values()}):
        sub = d / f"{shape[0]}x{shape[1]}"
        sub.mkdir()
        torch.save({n: c for n, c in cases.items() if CASES[n][0] == shape},
                   sub / "tp_inputs.pt")
        procs.append((sub, _ranks(shape[0] * shape[1], shape[0], sub)))
    out = {}
    for sub, ranks in procs:
        _wait(ranks)
        out.update(torch.load(sub / "tp_out.pt"))
    return cases, out, want


def _close(got, want, what: str) -> None:
    for (p, g), (_, w) in zip(flatten_with_path(got), flatten_with_path(want)):
        g, w = g.double(), w.double()
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= TOL * scale, \
            f"{what}/{path_name(p)}"


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_steps_match_one_process(runs, name):
    cases, out, _ = runs
    case, got = cases[name], out[name]
    bundle = lm_bundle_f32(case["arch"], **case["changes"])
    tr = Trainer(bundle.loss_fn(), case["params"],
                 TrainerConfig(opt=bundle.opt, microbatches=MICRO,
                               log_every=1), device="cpu")
    tr.fit(lambda c: case["batches"][c], len(case["batches"]))
    assert len(got["losses"]) == 2
    for g, h in zip(got["losses"], tr.history):
        assert abs(g / h["loss"] - 1) <= TOL
    _close(got["params"], tr.params, name)
    assert got["collectives"] > 0
    # the shapes computed with: the split leaves' halves, nothing else
    full = {path_name(p): tuple(t.shape)
            for p, t in flatten_with_path(case["params"])}
    want = {}
    for leaf, dim in EXPECT[name].items():
        shape = list(full[leaf])
        shape[dim] //= 2
        want[leaf] = tuple(shape)
    assert got["shapes"] == want
    if bundle.config.moe is not None:
        drops = sum(v for coord, v in got["dropped"] if coord[1] == 0)
        assert drops == tr.loss_fn.take_dropped() > 0


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_model_shards_reduce_as_their_whole_leaves(runs, shape):
    """``compress_tree`` and ``global_norm`` of a tree holding a leaf's
    ``model`` shard, on each rank: the shard takes its whole leaf's int8
    scale, so its values are the whole leaf's compression's columns bit
    for bit (the leaf's largest value lies in rank 0's columns), the whole
    leaf beside it is compressed alone, and the norm is the whole tree's
    within 1e-6."""
    from repro_torch.distributed.compression import compress_tree
    from repro_torch.train.optim import global_norm

    _, out, _ = runs
    whole = reduction_tree()
    want, norm = compress_tree(whole), float(global_norm(whole))
    k = whole["a"].shape[1] // 2
    for r, got, gn in out[f"reductions_{shape}"]:
        assert torch.equal(got["a"], want["a"][:, r * k:(r + 1) * k])
        assert torch.equal(got["b"], want["b"])
        assert abs(float(gn) / norm - 1) <= TOL


def test_granite_2x2_matches_the_reference_gspmd_step(runs):
    """granite REDUCED on (2, 2): the port's ranks against the JAX
    package's jitted step under the bundle's shardings."""
    _, out, want = runs
    got = out["granite_2x2"]
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g / w - 1) < LOSS_RTOL
    for p, t in flatten_with_path(got["params"]):
        ref = want["final/" + path_name(p)]
        assert np.abs(ref - t.numpy()).max() < PARAM_TOL, path_name(p)


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


@pytest.mark.parametrize("arch", ["granite-3-2b", MOE_ARCH])
def test_backward_on_another_thread_takes_the_same_route(one_rank, arch):
    """On the card autograd runs the backward pass, and with it every
    recomputed block and loss chunk, on a thread of its own, where the
    mesh and model-group contexts are not set.  A backward run on
    another thread here issues the same ``model`` collectives, and gives
    the same gradients within 1e-6 (the tied table's sums land in
    another order from run to run on threads), as one on a thread that
    carries the calling thread's contexts."""
    import contextvars
    import threading

    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.sharding import gather_except, place
    from repro_torch.distributed.tensor_parallel import (
        MODEL_COLLECTIVES,
        model_group_of,
        use_model_group,
    )
    from repro_torch.tree import leaves, tree_map

    bundle = lm_bundle_f32(arch)
    params = tree_map(lambda t: gather_except(t, "model"), tree_map(
        place, bundle.init(torch.Generator().manual_seed(0)),
        bundle.param_shardings(one_rank)))
    batch = _batches(bundle.config.vocab, 64)[0]
    loss_fn = bundle.loss_fn()
    runs = []
    for carried in (True, False):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        params)
        MODEL_COLLECTIVES.reset()
        with use_mesh(one_rank), use_model_group(model_group_of(one_rank)):
            loss = loss_fn(live, batch)
            ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run if carried else loss.backward,
                             args=(loss.backward,) if carried else ())
        t.start()
        t.join()
        runs.append((MODEL_COLLECTIVES.count,
                     [p.grad for p in leaves(live)]))
    (n0, g0), (n1, g1) = runs
    assert n0 == n1 > 0
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= TOL * float(a.abs().max())


def test_launcher_trains_through_the_split_loss():
    """``launch.train`` hands its ``Trainer`` an ``LMLoss``, so with
    ``--mesh`` its step computes on the weights' ``model`` shards."""
    from repro_torch.launch.train import main
    from repro_torch.models.transformer import LMLoss

    trainer = main(["--device", "cpu", "--steps", "1", "--batch", "2",
                    "--seq", "32"])
    assert isinstance(trainer.loss_fn, LMLoss)
    assert trainer.step_num == 1 and np.isfinite(trainer.history[-1]["loss"])
