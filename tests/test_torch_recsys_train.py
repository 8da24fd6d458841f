"""The port's recsys training slice against the JAX package, on the CPU:
the four recsys losses and their gradients, ``softmax_xent``, the
embedding bag's ``autograd.Function``, the trainer on DLRM-MLPerf, the
two-tower loop of ``examples/recsys_retrieval.py``, the training cells
of the registry, the f32 master layout, the attention kernels' grad
guard, and the pure-CPU helpers of ``chip_smoke.py``'s "recsys train"
phase.

Weights come from the reference's ``*_init`` and cross over as numpy
arrays (``recsys_params_from_jax(..., masters=True)``); batches are drawn
with numpy from a seed.  Tolerances, each stated where it is used:
  * f32 losses within 1e-6 relative; f32 gradients within 1e-5 of each
    leaf's largest gradient (measured: 9e-7), plus 1e-8 of the tree's
    largest for a leaf whose true gradient is 0 (DIN's attention-output
    bias: the softmax is shift invariant, so only rounding is left);
  * bf16: the two sides round to bf16 at other places (2^-8 relative
    each), so losses within 1e-3 relative and gradients within 2e-2 of
    the tree's largest gradient (measured: 6e-3).
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle
from repro.kernels.embedding_bag import embedding_bag_fixed_ref
from repro.models import recsys as ref_rs
from repro.nn import layers as ref_layers
from repro.train import optim as ref_optim
from repro.train import trainer as ref_trainer

from repro_torch.configs.families import RECSYS_BATCH_SIZES, RECSYS_OPT
from repro_torch.configs.registry import (
    RECSYS_ARCH_IDS,
    get_serving,
    get_training,
)
from repro_torch.convert import recsys_params_from_jax
from repro_torch.kernels.cuda_lib import require_no_grad
from repro_torch.kernels.embedding_bag import (
    embedding_bag_fixed,
    embedding_bag_fixed_plain,
    embedding_bags,
    embedding_bags_plain,
)
from repro_torch.kernels.flash_attention.kernel import (
    NO_GRAD_HINT,
    flash_attention,
)
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.models import recsys as port_rs
from repro_torch.nn import layers as port_layers
from repro_torch.train.optim import OptConfig, adamw_init, adamw_update
from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOSSES = {"dlrm-mlperf": "dlrm_loss", "din": "din_loss",
          "sasrec": "sasrec_loss", "two-tower-retrieval": "twotower_loss"}
INITS = {"dlrm-mlperf": "dlrm_init", "din": "din_init",
         "sasrec": "sasrec_init", "two-tower-retrieval": "twotower_init"}
# SASRec's loss runs in chunks of 5 positions where S allows: 20 does
SASREC_SEQ = 20


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _train_batch(arch: str, cfg, rng, n: int) -> dict:
    """A training batch of ``n`` rows for ``arch``, ids in range."""
    def ids(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int32)

    if arch == "dlrm-mlperf":
        return {"dense": rng.rand(n, cfg.n_dense).astype(np.float32),
                "sparse": np.stack([ids(r, n) for r in cfg.table_rows], 1),
                "label": (rng.rand(n) < 0.5).astype(np.float32)}
    if arch == "din":
        mask = (rng.rand(n, cfg.seq_len) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        return {"hist_items": ids(cfg.n_items, n, cfg.seq_len),
                "hist_cates": ids(cfg.n_cates, n, cfg.seq_len),
                "hist_mask": mask, "target_item": ids(cfg.n_items, n),
                "target_cate": ids(cfg.n_cates, n),
                "label": (rng.rand(n) < 0.5).astype(np.float32)}
    if arch == "sasrec":
        labels = ids(cfg.n_items, n, cfg.seq_len)
        labels[rng.rand(n, cfg.seq_len) < 0.2] = -1     # padded positions
        return {"seq": ids(cfg.n_items, n, cfg.seq_len), "labels": labels}
    return {"user_id": ids(cfg.n_users, n), "user_ctx": ids(cfg.n_context, n),
            "item_id": ids(cfg.n_items, n), "item_cat": ids(cfg.n_context, n)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = get_bundle(arch, reduced=True).config
    if arch == "sasrec":
        cfg = dataclasses.replace(cfg, seq_len=SASREC_SEQ)
    return getattr(ref_rs, INITS[arch])(cfg, jax.random.PRNGKey(1))


def _models(arch: str, dtype: str):
    """(reference cfg, reference params, port cfg, port f32 masters)."""
    jd, td = DTYPES[dtype]
    extra = {"seq_len": SASREC_SEQ} if arch == "sasrec" else {}
    rcfg = dataclasses.replace(get_bundle(arch, reduced=True).config,
                               dtype=jd, **extra)
    pcfg = dataclasses.replace(get_training(arch, reduced=True).config,
                               dtype=td, **extra)
    rparams = _ref_params(arch)
    pparams = recsys_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), CPU, masters=True)
    return rcfg, rparams, pcfg, pparams


# ----------------------------------------------------------------- losses --
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_loss_and_gradients_match_reference(arch, dtype):
    rcfg, rparams, pcfg, pparams = _models(arch, dtype)
    bj, bt = _both(_train_batch(arch, rcfg, np.random.RandomState(3), 16))
    ref_loss = getattr(ref_rs, LOSSES[arch])
    port_loss = getattr(port_rs, LOSSES[arch])
    grad_fn = jax.value_and_grad(lambda p: ref_loss(rcfg, p, bj))
    # f32 jitted, for speed; bf16 op by op, so that both sides round to
    # bf16 after every op (XLA's fusions keep some bf16 steps in f32)
    lj, gj = (jax.jit(grad_fn) if dtype == "f32" else grad_fn)(rparams)
    lt, gt = value_and_grad(lambda p, b: port_loss(pcfg, p, b), pparams, bt)
    assert lt.dtype == torch.float32 and lt.shape == ()
    flat_j = [_f32(g) for g in jax.tree_util.tree_leaves(gj)]
    flat_t = leaves(gt)
    assert len(flat_j) == len(flat_t)
    assert all(g.dtype == torch.float32 for g in flat_t)   # f32 masters
    tree_max = max(np.abs(g).max() for g in flat_j)
    if dtype == "f32":
        assert abs(float(lt) / float(lj) - 1) < 1e-6
        for j, t in zip(flat_j, flat_t):
            tol = 1e-5 * np.abs(j).max() + 1e-8 * tree_max
            assert np.abs(_f32(t) - j).max() <= tol
    else:
        assert abs(float(lt) / float(lj) - 1) < 1e-3
        err = max(np.abs(_f32(t) - j).max() for j, t in zip(flat_j, flat_t))
        assert err <= 2e-2 * tree_max


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_softmax_xent_matches_reference(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 5, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (3, 5)).astype(np.int32)
    labels[0, :2] = -1
    lj, gj = jax.value_and_grad(lambda x: ref_layers.softmax_xent(
        x.astype(jd), jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    lt = port_layers.softmax_xent(x.to(td), torch.from_numpy(labels))
    (gt,) = torch.autograd.grad(lt, x)
    assert lt.dtype == torch.float32
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 1e-6
    assert np.all(gt.numpy()[0, :2] == 0.0)
    none = torch.full((2,), -1, dtype=torch.int32)
    assert float(port_layers.softmax_xent(torch.zeros(2, 4), none)) == 0.0


def test_bce_logits_matches_reference():
    """Values and gradients, logits of 0 (under both labels) included."""
    rng = np.random.RandomState(5)
    logits = np.concatenate([rng.randn(30) * 8, [0.0, 0.0, 40.0, -40.0]]
                            ).astype(np.float32)
    labels = (rng.rand(34) < 0.5).astype(np.float32)
    labels[30:32] = [0.0, 1.0]
    lj, gj = jax.value_and_grad(lambda x: ref_rs.bce_logits(
        x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    lt = port_rs.bce_logits(x, torch.from_numpy(labels))
    (gt,) = torch.autograd.grad(lt, x)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 1e-7


# -------------------------------------------------------- the bag Function --
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bag_backward_matches_jax_grad_of_reference(dtype, K, weighted):
    """Gradients of ``sum(out * cot)`` in the table (and, ``weighted``, in
    the weights) against ``jax.grad`` of ``embedding_bag_fixed_ref``, with
    ids repeated inside and across bags.  f32 within 1e-6 (sums of a few
    products in another order); bf16 within 2e-2 of the largest
    gradient: the reference's oracle multiplies and sums in bf16, the
    port in f32."""
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(6)
    V, D, B = 12, 16, 9
    table = (rng.randn(V, D) * 0.5).astype(np.float32)
    ids = rng.randint(0, V, (B, K)).astype(np.int32)
    ids[0] = ids[1]          # a row repeated across bags
    ids[2, :] = 3            # and inside one
    w = (rng.rand(B, K) + 0.5).astype(np.float32) if weighted else \
        np.ones((B, K), np.float32)
    cot = rng.randn(B, D).astype(np.float32)

    def ref(t, ww):
        out = embedding_bag_fixed_ref(t.astype(jd), jnp.asarray(ids), ww)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot))

    gt_j, gw_j = jax.grad(ref, argnums=(0, 1))(jnp.asarray(table),
                                               jnp.asarray(w))
    t = torch.from_numpy(table).to(td).requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(weighted)
    out = embedding_bag_fixed(t, torch.from_numpy(ids), ww)
    assert out.dtype == td and out.grad_fn is not None
    grads = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(),
                                [t, ww] if weighted else [t])
    assert grads[0].dtype == td
    tol = 1e-6 if dtype == "f32" else 2e-2 * np.abs(np.asarray(gt_j)).max()
    assert np.abs(_f32(grads[0]) - _f32(gt_j)).max() <= tol
    untouched = np.setdiff1d(np.arange(V), ids)
    assert np.all(_f32(grads[0])[untouched] == 0.0)
    if weighted:
        tol = 1e-5 if dtype == "f32" else 2e-2 * np.abs(np.asarray(gw_j)).max()
        assert np.abs(_f32(grads[1]) - np.asarray(gw_j)).max() <= tol


def test_bag_function_is_the_plain_version_forward_and_its_own_backward():
    """On the CPU the Function's forward is the plain version, bit for
    bit; its backward is the scatter-add, not the plain version's own
    indexing backward, and agrees with it; ids get no gradient."""
    rng = np.random.RandomState(7)
    table = torch.from_numpy(rng.randn(20, 8).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 20, (6, 3)).astype(np.int32))
    w = torch.from_numpy(rng.rand(6, 3).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out_fn = embedding_bag_fixed(a, ids, w)
    out_plain = embedding_bag_fixed_plain(b, ids, w)
    assert torch.equal(out_fn, out_plain)
    assert "EmbeddingBagFixed" in type(out_fn.grad_fn).__name__
    cot = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    (ga,) = torch.autograd.grad(out_fn, a, cot)
    (gb,) = torch.autograd.grad(out_plain, b, cot)
    assert float((ga - gb).abs().max()) <= 1e-6
    with torch.no_grad():
        assert embedding_bag_fixed(a, ids, w).grad_fn is None


# ---------------------------------------------------------------- trainer --
@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_trainer_fit_matches_reference_on_dlrm(microbatches, compress):
    """DLRM-MLPerf REDUCED in f32 with the recsys bundle's optimizer, four
    steps through each package's ``Trainer``: per-step losses within 1e-6
    relative, parameters within 1e-7.  The f32 gradients agree to about
    1e-8 (test above); Adam's step turns a gradient difference dg near
    zero into at most lr * dg / eps, below 1e-7 at this warm-up lr
    (1e-5 per step number), while a missing or wrong gradient would move
    a parameter by lr a step, 1e-5 or more.  With compression one more
    difference is legitimate: where g / scale lies within rounding of a
    half, the int8 code rounds the other way on one side, and that
    element's step may then differ by up to 2 lr a step (one element of
    322,513 here); so at most 1e-4 of the elements may exceed 1e-7, and
    none the sum of 2 lr over the steps."""
    rcfg, rparams, pcfg, pparams = _models("dlrm-mlperf", "f32")
    n = get_training("dlrm-mlperf", reduced=True).batch_size // 4

    def batches(cursor):
        return _train_batch("dlrm-mlperf", rcfg, np.random.RandomState(
            100 + cursor), n)

    opt = {f.name: getattr(RECSYS_OPT, f.name)
           for f in dataclasses.fields(RECSYS_OPT)}
    rt = ref_trainer.Trainer(
        lambda p, b: ref_rs.dlrm_loss(rcfg, p, b), rparams,
        ref_trainer.TrainerConfig(opt=ref_optim.OptConfig(**opt),
                                  microbatches=microbatches,
                                  compress_grads=compress, log_every=1))
    rt.fit(lambda c: {k: jnp.asarray(v) for k, v in batches(c).items()}, 4)
    pt = Trainer(lambda p, b: port_rs.dlrm_loss(pcfg, p, b), pparams,
                 TrainerConfig(opt=RECSYS_OPT, microbatches=microbatches,
                               compress_grads=compress, log_every=1),
                 device=CPU)
    pt.fit(batches, 4)
    for r, p in zip(rt.history, pt.history):
        assert abs(p["loss"] / r["loss"] - 1) < 1e-6
        assert p["lr"] == r["lr"]
    diff = np.concatenate([
        np.abs(_f32(g) - np.asarray(w)).ravel()
        for w, g in zip(jax.tree_util.tree_leaves(rt.params), leaves(pt.params))])
    if compress:
        assert (diff >= 1e-7).sum() <= 1e-4 * diff.size
        assert diff.max() <= 2 * sum(h["lr"] for h in pt.history)
    else:
        assert diff.max() < 1e-7


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_two_tower_example_loop_matches_reference(dtype):
    """The training loop of ``examples/recsys_retrieval.py`` (reduced
    two-tower, temperature 0.2, in-batch softmax, AdamW at 3e-3) for 20
    steps in both packages.  In f32 the per-step losses agree within
    1e-5 relative; in bf16, the example's dtype, the two sides' bf16
    roundings feed 20 Adam steps and the losses drift apart by up to
    about 1% (measured 0.9%), held to 2e-2."""
    jd, td = DTYPES[dtype]
    bundle = get_bundle("two-tower-retrieval", reduced=True)
    cfg = dataclasses.replace(bundle.config, temperature=0.2, dtype=jd)
    params = bundle.init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(
        get_training("two-tower-retrieval", reduced=True).config,
        temperature=0.2, dtype=td)
    pparams = recsys_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, params), CPU, masters=True)

    def batch(seed):
        r = np.random.RandomState(seed)
        items = r.choice(cfg.n_items, 64, replace=False)
        return {"user_id": items % cfg.n_users, "user_ctx": items % cfg.n_context,
                "item_id": items, "item_cat": items % cfg.n_context}

    kw = dict(lr=3e-3, schedule="const", warmup_steps=1, weight_decay=0.0)
    oc = ref_optim.OptConfig(**kw)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(
            lambda pp, bb: ref_rs.twotower_loss(cfg, pp, bb))(p, b)
        p2, s2, _ = ref_optim.adamw_update(oc, g, s, p)
        return loss, p2, s2

    state, pstate, poc = ref_optim.adamw_init(params), adamw_init(pparams), \
        OptConfig(**kw)
    tol = 1e-5 if dtype == "f32" else 2e-2
    first = None
    for i in range(20):
        bj, bt = _both(batch(i))
        loss, params, state = step(params, state, bj)
        ploss, g = value_and_grad(
            lambda p, b: port_rs.twotower_loss(pcfg, p, b), pparams, bt)
        pparams, pstate, _ = adamw_update(poc, g, pstate, pparams, donate=True)
        assert abs(float(ploss) / float(loss) - 1) < tol, i
        first = first or float(ploss)
    assert float(ploss) < 0.5 * first          # it trains


# ------------------------------------------------------- registry, layout --
def _ref_train_config(bundle):
    """The ``TrainerConfig`` inside the reference bundle's train step."""
    fn = bundle.cells["train_batch"].fn
    return next(c.cell_contents for c in fn.__closure__
                if isinstance(c.cell_contents, ref_trainer.TrainerConfig))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_training_cell_equals_reference_bundle(arch, reduced):
    bundle = get_bundle(arch, reduced=reduced)
    tr = get_training(arch, reduced=reduced)
    assert tr.name == arch and tr.config == get_serving(arch, reduced).config
    assert tr.loss is getattr(port_rs, LOSSES[arch])
    batch = bundle.cells["train_batch"].inputs["batch"]
    assert {leaf.shape[0] for leaf in jax.tree_util.tree_leaves(batch)} \
        == {tr.batch_size}
    if not reduced:
        assert tr.batch_size == RECSYS_BATCH_SIZES["train_batch"] == 65_536
    ref_tc = _ref_train_config(bundle)
    assert ref_tc.microbatches == 1 and not ref_tc.compress_grads
    assert dataclasses.asdict(ref_tc.opt) == dataclasses.asdict(tr.opt)


def test_train_step_matches_reference_train_cell():
    """One step of the reduced DLRM train cell, in the bundle's own
    (bf16) compute: the reference's cell fn against the port's
    ``train_step()`` from the same masters and batch."""
    bundle = get_bundle("dlrm-mlperf", reduced=True)
    tr = get_training("dlrm-mlperf", reduced=True)
    rparams = bundle.init(jax.random.PRNGKey(2))
    pparams = recsys_params_from_jax(
        tr.config, jax.tree_util.tree_map(np.asarray, rparams), CPU,
        masters=True)
    bj, bt = _both(_train_batch("dlrm-mlperf", tr.config,
                                np.random.RandomState(8), tr.batch_size))
    _, _, rm = jax.jit(bundle.cells["train_batch"].fn)(
        rparams, ref_optim.adamw_init(rparams), bj)
    p2, s2, pm = tr.train_step()(pparams, adamw_init(pparams), bt)
    assert abs(float(pm["loss"]) / float(rm["loss"]) - 1) < 1e-3
    assert float(pm["lr"]) == float(rm["lr"]) and int(s2["step"]) == 1
    assert all(a is b for a, b in zip(leaves(p2), leaves(pparams)))  # donated


@pytest.mark.parametrize("arch", RECSYS_ARCH_IDS)
def test_masters_are_f32_and_serving_stays_in_the_config_dtype(arch):
    sv = get_serving(arch, reduced=True)
    init = getattr(port_rs, INITS[arch])
    masters = init(sv.config, torch.Generator().manual_seed(0), masters=True)
    serving = init(sv.config, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in leaves(masters))
    assert {t.dtype for t in leaves(serving)} <= {torch.bfloat16, torch.float32}
    assert any(t.dtype == torch.bfloat16 for t in leaves(serving))
    tree = jax.tree_util.tree_map(np.asarray, _ref_params(arch))
    got = recsys_params_from_jax(sv.config, tree, CPU, masters=True)
    for w, g in zip(jax.tree_util.tree_leaves(tree), leaves(got)):
        assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w)


def test_get_training_rejects_a_non_recsys_arch():
    with pytest.raises(ValueError, match="not a recsys arch"):
        get_training("granite-3-2b")


# ------------------------------------------------- the attention grad guard --
def test_attention_grad_guard():
    """The bare CUDA attention wrappers have no backward:
    ``require_no_grad`` (called by both on CUDA operands) raises when an
    operand requires grad under grad mode, saying what to call instead
    (the flash kernel's ``autograd.Function``); the CPU wrappers run their
    plain versions, which differentiate."""
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    kv = torch.randn(1, 2, 4, 8)
    with pytest.raises(RuntimeError, match="flash_attention_differentiable"):
        require_no_grad("flash_attention", q, kv, kv, hint=NO_GRAD_HINT)
    with torch.no_grad():
        require_no_grad("flash_attention", q, kv, kv)
    require_no_grad("flash_attention", kv, kv, kv)
    assert flash_attention(q, kv, kv).grad_fn is not None
    pool = torch.randn(2, 4, 8)
    out = paged_attention(torch.randn(1, 2, 8, requires_grad=True), pool, pool,
                          torch.tensor([[0, 1]], dtype=torch.int32),
                          torch.tensor([6], dtype=torch.int32))
    assert out.grad_fn is not None


def test_both_attention_wrappers_call_the_guard():
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
    for name in ("flash_attention", "paged_attention"):
        src = (root / name / "kernel.py").read_text()
        assert f'require_no_grad("{name}"' in src


# ------------------------------------------------ the card phase's helpers --
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_rows_cut():
    cs = _chip_smoke()
    tr = get_training("dlrm-mlperf")
    rows, cuts = cs.capped_rows(tr.config.table_rows, cs.TRAIN_ROW_CAP)
    assert cs.TRAIN_ROW_CAP == 2 ** 22 and len(rows) == 26
    assert [c.split(":")[0] for c in cuts] == ["t0", "t9", "t19", "t20", "t21"]
    assert sum(rows) == 23_458_556
    assert sum(rows) * tr.config.embed_dim * 16 < 48.1e9   # f32 state


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_grad_check_passes_clean_and_fails_a_cut_gradient(dtype):
    """``chip_smoke``'s gradient check on the reduced DLRM, where small
    tables collect many contributions a row (t5: 3 rows, about 85 each)
    and large ones leave rows untouched: the Function's route against the
    plain version's passes; a gradient missing one contribution, a table
    left at zero, a stray row and an unequal loss each fail."""
    cs = _chip_smoke()
    tr = get_training("dlrm-mlperf", reduced=True)
    cfg = dataclasses.replace(tr.config, dtype=dtype)
    params = tr.init(cfg, torch.Generator().manual_seed(0), masters=True)
    batch = cs.train_batch(cfg, 256, 5, CPU)
    kern = cs.route_grads(cfg, params, batch, embedding_bags)
    plain = cs.route_grads(cfg, params, batch, embedding_bags_plain)
    tables, failures = cs.grad_failures(kern, plain)
    assert failures == [] and len(tables) == 26
    assert all(t["kernel"]["nonzero"] and t["max_abs_diff"] <= 1e-6
               for t in tables.values())

    def broken(edit):
        res = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in kern.items()}
        res["grads"] = {n: g.clone() for n, g in kern["grads"].items()}
        edit(res)
        return cs.grad_failures(res, plain)[1]

    def drop_one(res):              # row ids[0] of t5 misses bag 0
        ids, cot = res["ids"]["t5"], res["cots"]["t5"]
        res["grads"]["t5"][ids[0]] -= cot[0]

    def zero(res):
        res["grads"]["t7"].zero_()

    def stray(res):
        g, ids = res["grads"]["t0"], res["ids"]["t0"]
        untouched = np.setdiff1d(np.arange(g.shape[0]), ids.numpy())[0]
        g[untouched, 0] = 1e-30

    def loss(res):
        res["loss"] = res["loss"] + 1e-6

    for edit, word in ((drop_one, "t5 off"), (zero, "t7 is zero"),
                       (stray, "t0 off"), (loss, "loss")):
        fails = broken(edit)
        assert any(word in f for f in fails), (edit.__name__, fails)


def test_chip_reduced_train_checks_pass_on_the_cpu():
    """The phase's REDUCED checks with the CPU in the card's place: the
    two runs agree and the resumed run matches the straight one."""
    out = _chip_smoke().reduced_train_checks(CPU)
    assert out["failures"] == []
    assert out["card_vs_cpu"]["steps"] == [1, 2, 3]
    assert out["resume"]["steps"] == [4, 5, 6]
    assert out["resume"]["max_state_abs_err"] == 0.0   # bit exact on the CPU
