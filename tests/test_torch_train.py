"""The port's training substrate against the JAX package, on the CPU:
optimizer schedules, AdamW, the global norm, int8 compression, the train
step with and without microbatches and compression, checkpoints (and
their exchange across packages in both directions), and the reference's
``tests/test_train.py`` scenarios run on the port.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances, each stated where it is used:
  * schedules: WSD and const bit for bit; cosine within an ulp of its
    ``cos`` carried through the schedule's products, because XLA's and
    PyTorch's f32 ``cos`` round differently in a few percent of
    arguments;
  * AdamW: params, ``mu`` and ``nu`` within 1e-6 relative in f32 (the
    global norm sums each leaf in another order, which moves the clip
    scale by an ulp or so);
  * int8 compression: bit for bit;
  * the train step on the quadratic problem: losses within 1e-6
    relative and params within 1e-6 absolute.  Its gradients are of
    order 1, far from zero, so Adam's normalised step cannot turn a
    rounding difference into a sign flip: the two sides move each
    parameter by the same lr-sized step and differ by rounding only.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import checkpoint as ref_ckpt
from repro.distributed import compression as ref_comp
from repro.train import optim as ref_optim
from repro.train import trainer as ref_trainer

from repro_torch.ckpt import checkpoint as port_ckpt
from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.distributed.compression import (
    compress_tree,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.train.optim import (
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
    schedule_lr,
)
from repro_torch.train.trainer import Trainer, TrainerConfig, build_train_step
from repro_torch.tree import flatten_with_path, leaves, path_name
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _t(tree):
    """A numpy tree as CPU tensors (copies)."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------- schedules --
SCHED = dict(lr=3e-3, warmup_steps=10, total_steps=100, decay_fraction=0.3,
             min_lr_ratio=0.1)


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
def test_schedule_matches_reference(schedule):
    """Steps 0-120 cover warmup, plateau, decay and past the end."""
    rc = ref_optim.OptConfig(schedule=schedule, **SCHED)
    pc = OptConfig(schedule=schedule, **SCHED)
    for s in range(121):
        want = np.asarray(ref_optim.schedule_lr(rc, jnp.asarray(s, jnp.int32)))
        got = schedule_lr(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        if schedule == "cosine":
            # an ulp of cos (at most 2^-24 for |cos| <= 1) scaled by lr
            # (1 - min) / 2, plus the products' own rounding
            tol = SCHED["lr"] * 2.0 ** -24 + 2 * np.spacing(want)
            assert abs(float(got) - float(want)) <= tol, s
        else:
            assert _np(got) == want, s


def test_wsd_schedule_shape():
    cfg = OptConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                    total_steps=100, decay_fraction=0.2, min_lr_ratio=0.1)
    lrs = [float(schedule_lr(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[5] < lrs[10]                      # warmup rises
    assert abs(lrs[40] - 1.0) < 1e-6             # stable plateau
    assert abs(lrs[79] - 1.0) < 1e-6             # still stable at 79 < 80
    assert lrs[95] < 0.5                         # decaying
    assert abs(lrs[100] - 0.1) < 1e-2            # ends at min ratio


# ----------------------------------------------------------------- AdamW --
def _opt_tree(rng, scale=1.0):
    """Keys whose sorted order (t0, t1, t10, t2) is not their insertion
    order, a nested dict and a list, as the recsys trees have."""
    return {
        "tables": {f"t{i}": {"table": (rng.randn(9, 4) * scale)
                             .astype(np.float32)} for i in (2, 10, 0, 1)},
        "blocks": [{"w": (rng.randn(5, 3) * scale).astype(np.float32)},
                   {"w": (rng.randn(3, 3) * scale).astype(np.float32)}],
        "b": (rng.randn(6) * scale).astype(np.float32),
    }


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("schedule", ["wsd", "const"])
def test_adamw_update_matches_reference(schedule, donate):
    """Same params, grads and (non-zero) state from numpy, three updates:
    params, mu and nu within 1e-6 relative in f32."""
    rng = np.random.RandomState(0)
    params, grads = _opt_tree(rng), _opt_tree(rng, 0.5)
    mu, nu = _opt_tree(rng, 0.1), jax.tree_util.tree_map(
        np.abs, _opt_tree(rng, 0.01))
    kw = dict(lr=1e-2, weight_decay=0.1, schedule=schedule, warmup_steps=3,
              total_steps=6, clip_norm=2.0)
    rc, pc = ref_optim.OptConfig(**kw), OptConfig(**kw)
    rp, rs = _j(params), {"mu": _j(mu), "nu": _j(nu),
                          "step": jnp.asarray(4, jnp.int32)}
    pp, ps = _t(params), {"mu": _t(mu), "nu": _t(nu),
                          "step": torch.tensor(4, dtype=torch.int32)}
    for _ in range(3):
        rp, rs, rm = ref_optim.adamw_update(rc, _j(grads), rs, rp)
        pp, ps, pm = adamw_update(pc, _t(grads), ps, pp, donate=donate)
        assert ps["step"].dtype == torch.int32 and int(ps["step"]) == int(rs["step"])
        assert _np(pm["lr"]) == np.asarray(rm["lr"])
        assert abs(float(pm["grad_norm"]) / float(rm["grad_norm"]) - 1) < 1e-6
        for want, got in ((rp, pp), (rs["mu"], ps["mu"]), (rs["nu"], ps["nu"])):
            for w, g in zip(jax.tree_util.tree_leaves(want), leaves(got)):
                assert g.dtype == torch.float32
                w = np.asarray(w)
                assert np.abs(_np(g) - w).max() <= 1e-6 * np.abs(w).max()


def test_adamw_donate_updates_in_place_and_not_otherwise():
    rng = np.random.RandomState(1)
    params, grads = _t(_opt_tree(rng)), _t(_opt_tree(rng))
    before = [p.clone() for p in leaves(params)]
    state = adamw_init(params)
    new, state2, _ = adamw_update(OptConfig(), grads, state, params)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert float(leaves(state["mu"])[0].abs().max()) == 0.0
    donated, _, _ = adamw_update(OptConfig(), grads, state, params,
                                 donate=True)
    assert all(a is b for a, b in zip(leaves(donated), leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(donated), leaves(new)))
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(state["mu"]), leaves(state2["mu"])))


def test_adamw_init_matches_reference():
    params = _opt_tree(np.random.RandomState(2))
    want = ref_optim.adamw_init(_j(params))
    got = adamw_init(_t(params))
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    assert [path_name(p) for p, _ in flatten_with_path(got)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert all(float(t.abs().max()) == 0.0 and t.dtype == torch.float32
               for t in leaves(got["mu"]) + leaves(got["nu"]))


def test_global_norm_sums_leaves_in_sorted_key_order():
    """f32 sums of 2^24, 1 and 1: (2^24 + 1) + 1 rounds to 2^24 twice,
    (1 + 1) + 2^24 does not, so only the reference's sorted order (t0,
    t1, t10) gives 4096 whatever the dict's insertion order."""
    tree = {"t1": np.ones(1, np.float32), "t10": np.ones(1, np.float32),
            "t0": np.full(1, 4096.0, np.float32)}
    want = np.asarray(ref_optim.global_norm(_j(tree)))
    got = global_norm(_t(tree))
    assert float(want) == 4096.0
    assert got.dtype == torch.float32 and _np(got) == want


def test_global_norm_matches_reference():
    """Within 1e-6 relative: each leaf's sum of squares runs in another
    order on each side."""
    tree = _opt_tree(np.random.RandomState(3))
    want = float(ref_optim.global_norm(_j(tree)))
    assert abs(float(global_norm(_t(tree))) / want - 1) < 1e-6


# ----------------------------------------------------------- compression --
def test_quantize_and_compress_tree_match_reference():
    rng = np.random.RandomState(4)
    x = (rng.randn(128, 64) * 3).astype(np.float32)
    x[0, :3] = np.array([0.5, -0.5, 1.5]) * np.abs(x).max() / 127.0  # ties
    q_ref, s_ref = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(_np(q), np.asarray(q_ref)) and _np(s) == np.asarray(s_ref)
    assert np.array_equal(_np(dequantize_int8(q, s)),
                          np.asarray(ref_comp.dequantize_int8(q_ref, s_ref)))
    tree = _opt_tree(rng)
    want = ref_comp.compress_tree(_j(tree))
    got = compress_tree(_t(tree))
    for w, g in zip(jax.tree_util.tree_leaves(want), leaves(got)):
        assert np.array_equal(_np(g), np.asarray(w))


def test_int8_compression_error_bounded():
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(128, 64) * 3).astype(np.float32))
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    # max error is half a quantization step
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-7
    tree = {"a": x, "b": torch.randn(4, generator=torch.Generator().manual_seed(0))}
    ct = compress_tree(tree)
    assert set(ct) == {"a", "b"} and ct["a"].shape == x.shape


# ------------------------------------------------------- the train step --
def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


def ref_quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def make_problem(n=256, d=8, seed=5):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d, 1)
    x = rng.randn(n, d)
    y = x @ w_true + 0.01 * rng.randn(n, 1)
    params = {"w": np.zeros((d, 1), np.float32), "b": np.zeros((1,), np.float32)}
    return params, {"x": x.astype(np.float32), "y": y.astype(np.float32)}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(microbatches, compress):
    params, batch = make_problem(n=64)
    opt = dict(lr=0.01, schedule="wsd", warmup_steps=2, total_steps=6)
    rstep = ref_trainer.build_train_step(ref_quad_loss, ref_trainer.TrainerConfig(
        opt=ref_optim.OptConfig(**opt), microbatches=microbatches,
        compress_grads=compress))
    pstep = build_train_step(quad_loss, TrainerConfig(
        opt=OptConfig(**opt), microbatches=microbatches,
        compress_grads=compress))
    rp = _j(params)
    rs = ref_optim.adamw_init(rp)
    pp = _t(params)
    ps = adamw_init(pp)
    for _ in range(5):
        rp, rs, rm = rstep(rp, rs, _j(batch))
        pp, ps, pm = pstep(pp, ps, _t(batch))
        assert abs(float(pm["loss"]) / float(rm["loss"]) - 1) < 1e-6
        for w, g in zip(jax.tree_util.tree_leaves(rp), leaves(pp)):
            assert np.abs(_np(g) - np.asarray(w)).max() < 1e-6


def test_adamw_converges():
    params, batch = make_problem()
    params, batch = _t(params), _t(batch)
    cfg = OptConfig(lr=0.05, schedule="const", warmup_steps=1,
                    weight_decay=0.0)
    state = adamw_init(params)
    l0 = float(quad_loss(params, batch))
    for _ in range(150):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        gw, gb = torch.autograd.grad(quad_loss(p, batch), [p["w"], p["b"]])
        params, state, _ = adamw_update(cfg, {"w": gw, "b": gb}, state, params)
    assert float(quad_loss(params, batch)) < 0.01 * l0


def test_grad_accumulation_matches_full_batch():
    params, batch = make_problem(n=64)
    opt = OptConfig(lr=0.01, schedule="const", warmup_steps=1)
    s1 = build_train_step(quad_loss, TrainerConfig(opt=opt, microbatches=1))
    s4 = build_train_step(quad_loss, TrainerConfig(opt=opt, microbatches=4))
    p1, _, _ = s1(_t(params), adamw_init(_t(params)), _t(batch))
    p4, _, _ = s4(_t(params), adamw_init(_t(params)), _t(batch))
    for a, b in zip(leaves(p1), leaves(p4)):
        assert float((a - b).abs().max()) < 1e-5


def test_compressed_training_still_converges():
    params, batch = make_problem()
    params, batch = _t(params), _t(batch)
    cfg = TrainerConfig(
        opt=OptConfig(lr=0.05, schedule="const", warmup_steps=1,
                      weight_decay=0.0),
        compress_grads=True,
    )
    step = build_train_step(quad_loss, cfg)
    opt = adamw_init(params)
    l0 = float(quad_loss(params, batch))
    for _ in range(150):
        params, opt, m = step(params, opt, batch)
    assert float(m["loss"]) < 0.05 * l0


# ------------------------------------------------------------ checkpoints --
def test_checkpoint_roundtrip(tmp_path):
    params, _ = make_problem()
    params = _t(params)
    opt = adamw_init(params)
    path = save_checkpoint(str(tmp_path), 7, params, opt, data_cursor=123)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    p2, o2, step, cursor = load_checkpoint(str(tmp_path), params, opt,
                                           device=CPU)
    assert step == 7 and cursor == 123
    for a, b in zip(leaves(params) + leaves(opt), leaves(p2) + leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_detects_corruption(tmp_path):
    params, _ = make_problem()
    params = _t(params)
    save_checkpoint(str(tmp_path), 1, params)
    d = os.path.join(str(tmp_path), "step_00000001")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(50)
        f.write(b"\xff\xff\xff")
    with pytest.raises(AssertionError, match="hash mismatch"):
        load_checkpoint(str(tmp_path), params, device=CPU)


def _ckpt_tree():
    rng = np.random.RandomState(6)
    params = _opt_tree(rng)
    opt = {"mu": _opt_tree(rng), "nu": _opt_tree(rng),
           "step": np.asarray(3, np.int32)}
    return params, opt


def test_checkpoint_files_equal_the_reference(tmp_path):
    """The same trees saved by each package: equal manifests (names,
    shapes, dtypes, hashes, step, cursor) and equal file bytes."""
    params, opt = _ckpt_tree()
    a = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, _j(params),
                                 _j(opt), data_cursor=9)
    b = save_checkpoint(str(tmp_path / "port"), 5, _t(params), _t(opt),
                        data_cursor=9)
    ma, mb = (json.load(open(os.path.join(p, "manifest.json"))) for p in (a, b))
    assert ma == mb
    assert "params/tables/t10/table" in mb["leaves"] and "opt/step" in mb["leaves"]
    for f in sorted(os.listdir(a)):
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_loads_across_packages(tmp_path, writer):
    params, opt = _ckpt_tree()
    if writer == "ref":
        ref_ckpt.save_checkpoint(str(tmp_path), 4, _j(params), _j(opt), 11)
        p, o, step, cursor = load_checkpoint(str(tmp_path), _t(params),
                                             _t(opt), device=CPU)
        got = leaves(p) + leaves(o)
    else:
        save_checkpoint(str(tmp_path), 4, _t(params), _t(opt), 11)
        p, o, step, cursor = ref_ckpt.load_checkpoint(
            str(tmp_path), _j(params), _j(opt))
        got = jax.tree_util.tree_leaves(p) + jax.tree_util.tree_leaves(o)
    want = jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(opt)
    assert (step, cursor) == (4, 11)
    for w, g in zip(want, got):
        g = _np(g)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_bf16_leaf_raises_type_error(tmp_path):
    """A bf16 leaf no longer raises: ``save_checkpoint`` and the manager
    write it (as its uint16 bits under the reference's ``<V2`` header)
    and it loads back as bf16, bit for bit."""
    params = {"w": torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16)}
    save_checkpoint(str(tmp_path / "a"), 1, params)
    mgr = CheckpointManager(str(tmp_path / "b"))
    mgr.save(1, params)
    mgr.wait()
    for d in ("a", "b"):
        p, _, _, _ = load_checkpoint(str(tmp_path / d), params, device=CPU)
        assert p["w"].dtype == torch.bfloat16
        assert torch.equal(p["w"].view(torch.int16),
                           params["w"].view(torch.int16))


def _bits(x) -> np.ndarray:
    """uint16 bit patterns of a bf16 JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _bf16_trees():
    """(name, reference tree, port tree) of ROADMAP's smallest bf16 input
    and of granite's REDUCED params cast to bf16, the same bits in both."""
    from repro.configs.registry import get_bundle as ref_bundle

    small = {"w": jnp.asarray([1.0, 2.5, -3.0], jnp.bfloat16),
             "b": jnp.zeros(2, jnp.float32)}
    lm = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        ref_bundle("granite-3-2b", reduced=True).init(jax.random.PRNGKey(0)))

    def port(tree):
        return jax.tree_util.tree_map(
            lambda a: torch.from_numpy(_bits(a).astype(np.int16)).view(
                torch.bfloat16) if a.dtype == jnp.bfloat16
            else torch.tensor(np.asarray(a)), tree)

    return [("small", small, port(small)), ("lm", lm, port(lm))]


@pytest.mark.parametrize("which", [0, 1], ids=["small", "lm_reduced"])
def test_bf16_checkpoint_matches_reference(tmp_path, which):
    """ROADMAP §3 fault 1: a bf16 tree saved by the reference loads in
    the port bit for bit, the port's files equal the reference's byte for
    byte (header ``'<V2'``, manifest dtype ``bfloat16``, same hashes),
    and a port round trip is exact."""
    name, ref_tree, port_tree = _bf16_trees()[which]
    a = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 2, ref_tree)
    b = save_checkpoint(str(tmp_path / "port"), 2, port_tree)
    ma, mb = (json.load(open(os.path.join(p, "manifest.json"))) for p in (a, b))
    assert ma == mb
    assert any(m["dtype"] == "bfloat16" for m in mb["leaves"].values())
    for f in sorted(os.listdir(a)):
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f
    want = jax.tree_util.tree_leaves(ref_tree)
    for src in ("ref", "port"):
        got, _, step, _ = load_checkpoint(str(tmp_path / src), port_tree,
                                          device=CPU)
        assert step == 2
        for w, g, t in zip(want, leaves(got), leaves(port_tree)):
            assert g.dtype == t.dtype and g.shape == t.shape
            if g.dtype == torch.bfloat16:
                assert np.array_equal(_bits(g), _bits(w)), name
            else:
                assert np.array_equal(g.numpy(), np.asarray(w)), name


def test_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"w": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3):
        mgr.save(s, params)
        params["w"].add_(1.0)          # the saved snapshot must not move
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    p, _, step, _ = load_checkpoint(str(tmp_path), params, device=CPU)
    assert step == 3 and p["w"].tolist() == [2.0, 3.0, 4.0, 5.0]
    assert latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------- Trainer --
def _quad_batches(batch):
    def batches(cursor):  # deterministic per-cursor batch
        rng = np.random.RandomState(cursor)
        idx = rng.choice(batch["x"].shape[0], 32, replace=False)
        return {"x": batch["x"][idx], "y": batch["y"][idx]}
    return batches


def test_crash_restart_resumes_exactly(tmp_path):
    """Train 10 steps straight vs train 5, 'crash', restore, train 5:
    bit-identical parameters and optimizer state on the CPU."""
    params, batch = make_problem()
    batches = _quad_batches(batch)

    def mk(ckpt_dir):
        return Trainer(
            quad_loss, params,
            TrainerConfig(
                opt=OptConfig(lr=0.01, schedule="const", warmup_steps=1),
                ckpt_dir=ckpt_dir, ckpt_every=5, log_every=100,
            ),
            device=CPU,
        )

    t_straight = mk(str(tmp_path / "a"))
    t_straight.fit(batches, 10)

    t_crash = mk(str(tmp_path / "b"))
    t_crash.fit(batches, 5)            # checkpoint lands at step 5
    t_crash.ckpt.wait()

    t_resumed = mk(str(tmp_path / "b"))   # fresh process analogue
    assert t_resumed.try_resume()
    assert t_resumed.step_num == 5 and t_resumed.data_cursor == 5
    t_resumed.fit(batches, 10)

    for a, b in zip(leaves(t_straight.params) + leaves(t_straight.opt_state),
                    leaves(t_resumed.params) + leaves(t_resumed.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_matches_reference_trainer(tmp_path):
    """Per-step losses (1e-6 relative) and the final params (1e-6) of the
    two Trainers over 6 steps, each checkpointing every 3."""
    params, batch = make_problem()
    batches = _quad_batches(batch)
    opt = dict(lr=0.01, schedule="wsd", warmup_steps=2, total_steps=6)
    rt = ref_trainer.Trainer(ref_quad_loss, _j(params), ref_trainer.TrainerConfig(
        opt=ref_optim.OptConfig(**opt), ckpt_dir=str(tmp_path / "r"),
        ckpt_every=3, log_every=1))
    rt.fit(lambda c: _j(batches(c)), 6)
    pt = Trainer(quad_loss, params, TrainerConfig(
        opt=OptConfig(**opt), ckpt_dir=str(tmp_path / "p"), ckpt_every=3,
        log_every=1), device=CPU)
    pt.fit(batches, 6)
    assert [h["step"] for h in pt.history] == list(range(1, 7))
    for r, p in zip(rt.history, pt.history):
        assert abs(p["loss"] / r["loss"] - 1) < 1e-6 and p["lr"] == r["lr"]
    for w, g in zip(jax.tree_util.tree_leaves(rt.params), leaves(pt.params)):
        assert np.abs(_np(g) - np.asarray(w)).max() < 1e-6
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "r"))


def test_trainer_leaves_the_callers_params_alone():
    params, batch = make_problem()
    params = _t(params)
    before = {k: v.clone() for k, v in params.items()}
    t = Trainer(quad_loss, params, TrainerConfig(log_every=1), device=CPU)
    t.fit(_quad_batches(batch), 2)
    assert all(torch.equal(before[k], params[k]) for k in params)
    assert not torch.equal(t.params["w"], params["w"])


def test_trainer_and_load_raise_without_cuda(monkeypatch, tmp_path):
    """``device=None`` means the card: without one both refuse."""
    params, _ = make_problem()
    save_checkpoint(str(tmp_path), 1, _t(params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(quad_loss, params, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ckpt.load_checkpoint(str(tmp_path), _t(params))


def test_a_steps_gradients_are_freed_without_the_garbage_collector():
    """At DLRM-MLPerf's widths a step's gradients are 12 GB: they must go
    when the step returns, not when the cyclic collector next runs (a
    reference cycle kept two steps' worth alive on the card)."""
    import gc
    import weakref

    from repro_torch.train.trainer import value_and_grad

    params, batch = make_problem(n=16)
    params, batch = _t(params), _t(batch)
    gc.disable()
    try:
        _, grads = value_and_grad(quad_loss, params, batch)
        ref = weakref.ref(grads["w"])
        del grads
        assert ref() is None
        seen = []
        step = build_train_step(
            lambda p, b: seen.append(weakref.ref(p["w"])) or quad_loss(p, b),
            TrainerConfig(), donate=True)
        step(params, adamw_init(params), batch)
        assert seen and seen[0]() is None      # the step's live leaves
    finally:
        gc.enable()
