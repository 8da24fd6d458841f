"""The port's collectives and its data-parallel step on CPU gloo groups,
against the JAX package and against the port's own single-process step.

Ranks are processes of ``tests/torch_mesh_workers.py`` on a file-store
gloo group (no network).

  * ``compressed_psum`` on 2 and 4 ranks against the reference's under
    ``shard_map`` over as many forced host devices
    (``tests/torch_mesh_ref.py psum``): bit for bit.  Both take the same
    f32 steps (max-abs scale / 127, pmax, round-half-even, clip, an exact
    int32 sum, one product).
  * On a (2, 1) ``("data", "model")`` mesh of 2 ranks and on a (2, 2)
    one of 4, whose ``model`` axis splits the weights: two ``Trainer``
    steps of granite-3-2b REDUCED in f32 (as ``test_torch_lm_train.py``
    holds it), in 2 microbatches whose ranks hold different counts of
    valid labels, two of moonshot-v1-16b-a3b REDUCED in f32 (MoE: the
    groups and the balance term of the global batch), and one step of
    MACE's masked ``minibatch_lg`` cell: losses and every parameter
    within ``tests/test_torch_train.py``'s 1e-6 of the same steps in one
    process (relative, over each leaf's largest value); so do one step
    of DLRM's and of two-tower's REDUCED cells in f32.
  * Fault 3: moonshot REDUCED on a global batch of 2 x 3 tokens, whose
    one dispatch group of 6 spans the two batch ranks (3 tokens each):
    the step within 1e-6 of one process, the drops of the ranks' own
    tokens summing to the one-process count, and the first layer's
    ``moe_apply`` on those rows within ``test_torch_moe.py``'s 1e-5 of
    the reference's on the whole batch.
  * A mesh checkpoint: the files of a save on the mesh equal an
    unsharded save's byte for byte; a save after the steps restores in
    one process (plain tensors), on a (1, 1) mesh and on the mesh it
    was saved on (elastic, with the bundle's shardings).
"""

import os
import subprocess
import sys
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as ref_moe

from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.registry import get_bundle
from repro_torch.launch.train import synth_lm_batches
from repro_torch.train.optim import adamw_init
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten_with_path, leaves, path_name, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gnn_cases import node_batch  # noqa: E402
from torch_mesh_ref import psum_inputs  # noqa: E402
from torch_mesh_workers import (  # noqa: E402
    LM_MICROBATCHES,
    MOE_ARCH,
    RECSYS_DP,
    lm_bundle_f32,
    recsys_f32,
)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")


def _ranks(case: str, world: int, d: Path, *extra: str) -> None:
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_workers.py"), case,
         str(r), str(world), str(d), *extra], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def _close(got, want, what: str) -> None:
    for (p, g), (_, w) in zip(flatten_with_path(got), flatten_with_path(want)):
        g, w = g.double(), w.double()
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= TOL * scale, \
            f"{what}/{path_name(p)}"


# ---------------------------------------------------------- compressed psum --
@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_matches_reference(world, tmp_path):
    ref = tmp_path / "ref.npz"
    subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "psum",
         str(world), "7", str(ref)], check=True, timeout=240,
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count="
                 f"{world}"))
    want = np.load(ref)
    x = psum_inputs(world, 7)
    assert np.array_equal(want["x"], x)
    np.save(tmp_path / "psum_in.npy", x)
    _ranks("psum", world, tmp_path)
    for r in range(world):
        got = np.load(tmp_path / f"psum_out_{r}.npy")
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32),
                              want["out"][r].view(np.uint32)), r
    # the ranks' scales differ by 4x each, so the common one is not ours
    assert not np.array_equal(want["out"][0], x.sum(0))


# ------------------------------------------------------ data-parallel step --
def _lm_batches(vocab: int, seq: int = 32):
    """Two batches of 8 x ``seq`` in 2 microbatches; rank 0's rows of each
    microbatch lose 20 labels, so the ranks' valid counts differ."""
    out = []
    for c in range(2):
        b = {k: torch.from_numpy(v)
             for k, v in synth_lm_batches(vocab, 8, seq)(c).items()}
        b["labels"][0, :20] = -1
        b["labels"][4, 5:25] = -1
        out.append(b)
    return out


def _recsys_batch(arch: str, cfg, n: int = 16) -> dict:
    rng = np.random.RandomState(9)
    if arch == "dlrm-mlperf":
        b = {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
             "sparse": np.stack([rng.randint(0, r, n) for r in cfg.table_rows],
                                1).astype(np.int32),
             "label": (rng.rand(n) < 0.5).astype(np.float32)}
    else:
        b = {"user_id": rng.randint(0, cfg.n_users, n),
             "user_ctx": rng.randint(0, cfg.n_context, n),
             "item_id": rng.randint(0, cfg.n_items, n),
             "item_cat": rng.randint(0, cfg.n_context, n)}
        b = {k: v.astype(np.int32) for k, v in b.items()}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _span_inputs(moe) -> dict:
    """Fault 3's step: a global batch of 2 x 3 tokens (one dispatch group
    of 6 over two batch ranks), its params, and 2 x 3 hidden rows for
    one ``moe_apply``."""
    batch = synth_lm_batches(moe.config.vocab, 2, 3)(0)
    x = np.random.RandomState(5).randn(2, 3, moe.config.d_model)
    return {"params": moe.init(torch.Generator().manual_seed(6)),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "x": torch.from_numpy(x.astype(np.float32))}


MESHES = {"2x1": (2, 2), "2x2": (4, 2)}   # mesh: (world, data ranks)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, tmp_path_factory):
    world, data = MESHES[request.param]
    d = tmp_path_factory.mktemp("mesh" + request.param)
    bundle = lm_bundle_f32()
    lm_params = bundle.init(torch.Generator().manual_seed(0))
    moe = lm_bundle_f32(MOE_ARCH)
    gnn = get_bundle("mace", reduced=True)
    cell = gnn.cell_specs["minibatch_lg"]
    gnn_params = cell.init(torch.Generator().manual_seed(1))
    (n, _), (e, _) = cell.inputs["feat"], cell.inputs["edges_src"]
    g = node_batch(n[0], e[0], cell.config.d_feat, cell.config.n_out,
                   np.random.RandomState(2), masked=True)
    g["label_mask"][: n[0] // 2] *= (np.arange(n[0] // 2) % 3 == 0)
    gnn_batch = {k: torch.from_numpy(v) for k, v in g.items()}
    inputs = {"lm_params": lm_params, "lm_batches": _lm_batches(
        bundle.config.vocab), "gnn_params": gnn_params, "gnn_batch": gnn_batch,
        # 64-token rows: each rank's half of a microbatch is one MoE group
        "moe_params": moe.init(torch.Generator().manual_seed(3)),
        "moe_batches": _lm_batches(moe.config.vocab, 64),
        "span": _span_inputs(moe)}
    for arch in RECSYS_DP:
        tr = recsys_f32(arch)
        inputs[arch] = {"params": tr.init(tr.config,
                                          torch.Generator().manual_seed(4),
                                          masters=True),
                        "batch": _recsys_batch(arch, tr.config)}
    torch.save(inputs, d / "inputs.pt")
    _ranks("train", world, d, str(data))
    return d, inputs, torch.load(d / "train_out.pt")


def test_data_parallel_lm_steps_match_one_process(mesh_run):
    d, inputs, out = mesh_run
    bundle = lm_bundle_f32()
    tr = Trainer(bundle.loss_fn(), inputs["lm_params"],
                 TrainerConfig(opt=bundle.opt, microbatches=LM_MICROBATCHES,
                               log_every=1), device="cpu")
    tr.fit(lambda c: inputs["lm_batches"][c], 2)
    want = [h["loss"] for h in tr.history]
    assert len(out["lm_losses"]) == 2
    for g, w in zip(out["lm_losses"], want):
        assert abs(g / w - 1) <= TOL
    _close(out["lm_params"], tr.params, "params")
    _close(out["lm_mu"], tr.opt_state["mu"], "mu")


def test_data_parallel_moe_steps_match_one_process(mesh_run):
    """MoE's groups are cut from the global batch and its balance term is
    the global batch's, counted once in the summed loss."""
    d, inputs, out = mesh_run
    moe = lm_bundle_f32(MOE_ARCH)
    assert moe.config.moe.group_tokens == 2 * 64
    tr = Trainer(moe.loss_fn(), inputs["moe_params"],
                 TrainerConfig(opt=moe.opt, microbatches=LM_MICROBATCHES,
                               log_every=1), device="cpu")
    tr.fit(lambda c: inputs["moe_batches"][c], 2)
    assert len(out["moe_losses"]) == 2
    for g, w in zip(out["moe_losses"], [h["loss"] for h in tr.history]):
        assert abs(g / w - 1) <= TOL
    _close(out["moe_params"], tr.params, "moe")


def _model_rank0_sum(per_rank) -> float:
    """The sum of a per-rank value over the batch ranks (the ranks at
    ``model`` coordinate 0)."""
    return sum(v for coord, v in per_rank if coord[1] == 0)


def test_moe_group_spanning_batch_ranks_matches_one_process(mesh_run):
    """Fault 3: the group size is cut from the global 6 tokens, so the
    one group spans both batch ranks; the ranks gather it, route it as
    one process does and keep their own rows."""
    d, inputs, out = mesh_run
    moe = lm_bundle_f32(MOE_ARCH)
    span = inputs["span"]
    assert moe.config.moe.group_tokens > 6
    tr = Trainer(moe.loss_fn(), span["params"],
                 TrainerConfig(opt=moe.opt, log_every=1), device="cpu")
    tr.fit(lambda c: span["batch"], 1)
    assert abs(out["span_loss"] / tr.history[0]["loss"] - 1) <= TOL
    _close(out["span_params"], tr.params, "span")
    want = tr.loss_fn.take_dropped()
    assert _model_rank0_sum(out["span_dropped"]) == want


def test_moe_apply_over_spanning_groups_matches_reference(mesh_run):
    """The first layer's ``moe_apply`` on the ranks' rows of a 2 x 3
    batch against the reference's on the whole batch (one group of 6)."""
    d, inputs, out = mesh_run
    cfg = lm_bundle_f32(MOE_ARCH).config.moe
    span = inputs["span"]
    p = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t[0].numpy()), span["params"]["block"]["moe"])
    x = span["x"].numpy()
    logits = x.reshape(-1, x.shape[-1]) @ np.asarray(p["router"]["w"])
    g = np.sort(np.exp(logits - logits.max(-1, keepdims=True)), -1)
    assert np.diff(g, axis=-1).min() > 1e-5 * g.max()
    y, aux = ref_moe.moe_apply(p, jnp.asarray(x),
                               ref_moe.MoEConfig(**dataclasses.asdict(cfg)),
                               dtype=jnp.float32)
    assert out["span_moe"].shape == x.shape
    assert np.abs(np.asarray(y) - out["span_moe"].numpy()).max() < 1e-5
    assert _model_rank0_sum(out["span_moe_dropped"]) == \
        float(aux["dropped_tokens"])


def test_data_parallel_masked_gnn_step_matches_one_process(mesh_run):
    d, inputs, out = mesh_run
    cell = get_bundle("mace", reduced=True).cell_specs["minibatch_lg"]
    params = tree_map(torch.clone, inputs["gnn_params"])
    params, _, m = cell.train_step()(params, adamw_init(params),
                                     inputs["gnn_batch"])
    assert abs(out["gnn_loss"] / float(m["loss"]) - 1) <= TOL
    _close(out["gnn_params"], params, "gnn")
    mask = inputs["gnn_batch"]["label_mask"]
    n = mask.shape[0] // 2
    assert float(mask[:n].sum()) != float(mask[n:].sum())


@pytest.mark.parametrize("arch", RECSYS_DP)
def test_data_parallel_recsys_step_matches_one_process(mesh_run, arch):
    """DLRM's rows split over the ranks; both archs' tables looked up
    where their rows lie and their MLPs on their columns (the bundle's
    ``RecsysLoss``); two-tower's towers on a rank's own rows against
    the whole batch's items."""
    d, inputs, out = mesh_run
    tr = recsys_f32(arch)
    params = tree_map(torch.clone, inputs[arch]["params"])
    params, _, m = tr.train_step()(params, adamw_init(params),
                                   inputs[arch]["batch"])
    assert abs(out[arch]["loss"] / float(m["loss"]) - 1) <= TOL
    _close(out[arch]["params"], params, arch)


def test_mesh_save_equals_an_unsharded_save(mesh_run, tmp_path):
    d, inputs, _ = mesh_run
    params = inputs["lm_params"]
    b = save_checkpoint(str(tmp_path), 0, params, adamw_init(params))
    a = os.path.join(d, "ckpt_init", "step_00000000")
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and "manifest.json" in files
    for f in files:
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


def test_elastic_restore_on_one_rank_and_two(mesh_run):
    d, inputs, out = mesh_run
    template = inputs["lm_params"]
    p, o, step, cursor = load_checkpoint(str(d / "ckpt"), template,
                                         adamw_init(template), device="cpu")
    assert (step, cursor) == (2, 2)
    assert all(not hasattr(t, "device_mesh") for t in leaves(p))
    for got, want in ((p, out["lm_params"]), (out["restored_params"], p),
                      (out["restored_own"], p), (out["restored_own_mu"],
                                                 o["mu"])):
        for g, w in zip(leaves(got), leaves(want)):
            assert torch.equal(g, w)
    assert out["restored_step"] == 2


def test_elastic_restore_on_a_one_rank_mesh(mesh_run, one_rank):
    d, inputs, out = mesh_run
    bundle = lm_bundle_f32()
    template = inputs["lm_params"]
    p, o, step, _ = load_checkpoint(
        str(d / "ckpt"), template, adamw_init(template), device="cpu",
        shardings=bundle.param_shardings(one_rank),
        opt_shardings=bundle.opt_shardings(one_rank))
    assert step == 2
    for got, want in ((p, out["lm_params"]), (o["mu"], out["lm_mu"])):
        for g, w in zip(leaves(got), leaves(want)):
            assert g.device_mesh is one_rank
            assert torch.equal(g.to_local(), w)


# ------------------------------------------------------- one-rank mesh --
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


@pytest.mark.parametrize("arch,compress", [
    ("granite-3-2b", False), ("granite-3-2b", True),
    ("moonshot-v1-16b-a3b", False)])
def test_one_rank_mesh_step_equals_the_unsharded_step(one_rank, arch,
                                                      compress):
    """On a (1, 1) mesh the step is the unsharded step bit for bit (the
    card's mesh phase asks this at granite's full widths), with int8
    gradient compression too, and the gathered params are the DTensors'
    own storage."""
    from repro_torch.distributed.hooks import use_mesh
    from repro_torch.distributed.sharding import full_tensor, place

    bundle = get_bundle(arch, reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v)
             for k, v in synth_lm_batches(bundle.config.vocab, 4, 32)(0).items()}
    tc = TrainerConfig(opt=bundle.opt, microbatches=2, compress_grads=compress,
                       log_every=1)
    plain = Trainer(bundle.loss_fn(), params, tc, device="cpu")
    plain.fit(lambda _: batch, 2)
    placed = tree_map(place, params, bundle.param_shardings(one_rank))
    mesh = Trainer(bundle.loss_fn(), placed, tc, device="cpu")
    with use_mesh(one_rank):
        mesh.fit(lambda _: batch, 2)
    assert [h["loss"] for h in mesh.history] == \
        [h["loss"] for h in plain.history]
    for tree in ("params", "opt_state"):
        for a, b in zip(leaves(getattr(mesh, tree)),
                        leaves(getattr(plain, tree))):
            assert torch.equal(a.to_local(), b)
    for t in leaves(mesh.params):
        assert full_tensor(t).data_ptr() == t.to_local().data_ptr()
