"""The port's LM training slice against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` and cross over as f32
masters (``transformer_params_from_jax(..., masters=True)``).
Tolerances, in f32:
  * ``lm_loss``: 1e-6 relative; each leaf's gradient within 1e-5 of the
    largest of its elements (the two sides sum the same f32 products in
    other orders: 2e-6 measured at REDUCED);
  * attention's plain backward (the ``autograd.Function``'s) against
    ``jax.grad`` of ``repro.models.attention.attention``: 1e-5 of each
    gradient's largest element;
  * three ``Trainer`` steps at the launcher's lr (1.5e-4, 3e-4 and
    4.5e-4 in warm-up): losses 1e-6 relative, parameters 1e-5.  Adam
    divides each gradient by its own running size, so the f32 noise of
    a gradient near zero moves that element's step by a visible fraction
    of lr (1.8e-6 measured); a wrong or missing gradient moves a
    parameter by about lr a step, 1.5e-4 or more.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import all_cells as ref_all_cells
from repro.configs.registry import get_bundle as ref_get_bundle
from repro.launch.train import synth_lm_batches as ref_synth
from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro.train import optim as ref_optim
from repro.train import trainer as ref_trainer

from repro_torch.configs.registry import (
    ARCH_IDS,
    LM_ARCH_IDS,
    RECSYS_ARCH_IDS,
    all_cells,
    get_bundle,
    get_config,
    shape_cells,
)
from repro_torch.convert import transformer_params_from_jax
from repro_torch.kernels.flash_attention import (
    flash_attention_differentiable,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_backward_plain,
)
from repro_torch.launch import train as port_launch
from repro_torch.models import transformer as port_tf
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, value_and_grad
from repro_torch.tree import flatten_with_path, leaves
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
ATTN_RTOL = 1e-5
PARAM_TOL = 1e-5


def _models(arch: str, **changes):
    """(reference cfg, reference params, port cfg, port f32 masters)."""
    rcfg = dataclasses.replace(ref_get_bundle(arch, reduced=True).config,
                               dtype=jnp.float32, **changes)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype=torch.float32, **changes)
    pparams = transformer_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), CPU, masters=True)
    return rcfg, rparams, pcfg, pparams


def _batch(vocab, B=2, S=64, seed=3):
    b = ref_synth(vocab, B, S)(seed)
    return np.array(b["tokens"]), np.array(b["labels"])


def _grad_errors(rgrads, pgrads):
    """Each leaf's largest error over its largest |reference| element."""
    ref = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, rgrads)))
    got = dict(flatten_with_path(pgrads))
    assert ref.keys() == got.keys()
    return {k: float(np.abs(ref[k] - got[k].numpy()).max()
                     / max(np.abs(ref[k]).max(), 1e-30)) for k in ref}


# ----------------------------------------------------------------- lm_loss --
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_lm_loss_and_grads_match_reference(arch):
    rcfg, rparams, pcfg, pparams = _models(arch)
    toks, labels = _batch(rcfg.vocab)

    def rloss(p):
        return ref_tf.lm_loss(rcfg, p, jnp.asarray(toks), jnp.asarray(labels))

    (rl, raux), rg = jax.value_and_grad(rloss, has_aux=True)(rparams)
    pl, pg = value_and_grad(
        lambda p, b: port_tf.lm_loss(pcfg, p, *b)[0], pparams,
        (torch.from_numpy(toks), torch.from_numpy(labels)))
    assert abs(float(pl) / float(rl) - 1) < LOSS_RTOL
    errs = _grad_errors(rg, pg)
    assert max(errs.values()) < GRAD_RTOL, errs
    _, paux = port_tf.lm_loss(pcfg, pparams, torch.from_numpy(toks),
                              torch.from_numpy(labels))
    assert set(paux) == set(raux)
    for key in raux:
        assert abs(float(paux[key]) - float(raux[key])) <= 1e-6 * max(
            1.0, abs(float(raux[key])))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"])
def test_moe_loss_adds_the_balance_term(arch):
    """An MoE loss is the chunked cross-entropy plus 0.01 * balance_loss /
    n_layers, the balance loss summed over layers as the reference's is."""
    _, _, pcfg, pparams = _models(arch)
    toks, labels = (torch.from_numpy(a) for a in _batch(pcfg.vocab))
    loss, aux = port_tf.lm_loss(pcfg, pparams, toks, labels)
    h, aux2 = port_tf.backbone(pcfg, pparams, toks)
    logits = port_tf._unembed_chunk(pcfg, pparams, h)
    xent = torch.nn.functional.cross_entropy(
        logits.reshape(-1, pcfg.vocab).float(), labels.reshape(-1).long(),
        ignore_index=-1)
    want = xent + 0.01 * aux2["balance_loss"] / pcfg.n_layers
    assert float(aux["balance_loss"]) > 0
    assert abs(float(loss) - float(want)) < 1e-5


def test_remat_changes_memory_not_values():
    """Per-block recompute (``remat`` dots or full) gives the loss and
    gradients of no recompute, bit for bit on the CPU."""
    out = {}
    for remat in ("none", "dots", "full"):
        _, _, pcfg, pparams = _models("moonshot-v1-16b-a3b", remat=remat)
        toks, labels = (torch.from_numpy(a) for a in _batch(pcfg.vocab))
        out[remat] = value_and_grad(
            lambda p, b: port_tf.lm_loss(pcfg, p, *b)[0], pparams,
            (toks, labels))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(leaves(out[remat][1]), leaves(out["none"][1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_lm_loss_in_bf16_near_reference(arch):
    """bf16 compute from f32 masters on both sides: the loss within 1e-2
    relative and each gradient's relative L2 error under 5e-2 (both round
    to bf16 at the same casts, but the port keeps attention's p @ v in
    f32 where the reference rounds p to bf16)."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    toks, labels = _batch(rcfg.vocab)
    rl, rg = jax.value_and_grad(lambda p: ref_tf.lm_loss(
        rcfg, p, jnp.asarray(toks), jnp.asarray(labels))[0])(rparams)
    pl, pg = value_and_grad(lambda p, b: port_tf.lm_loss(pcfg, p, *b)[0],
                            pparams, (torch.from_numpy(toks),
                                      torch.from_numpy(labels)))
    assert abs(float(pl) / float(rl) - 1) < 1e-2
    ref = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, rg)))
    for k, g in flatten_with_path(pg):
        assert g.dtype == torch.float32
        r = ref[k].astype(np.float64)
        err = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), 1e-30)
        assert err < 5e-2, (k, err)


# --------------------------------------------------------------- attention --
ATTN_CASES = [  # B, H, Hkv, S, D, causal, rows
    (2, 4, 4, 24, 16, True, 512),
    (1, 8, 2, 37, 8, True, 16),
    (2, 6, 3, 20, 32, False, 7),
    (1, 4, 1, 64, 64, True, 24),
]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,rows", ATTN_CASES)
def test_attention_backward_matches_reference(B, H, Hkv, S, D, causal, rows):
    """The Function's plain backward, query rows taken ``rows`` at a time,
    against ``jax.grad`` of the reference's attention on the same
    (B, S, H, D) operands and cotangent."""
    rng = np.random.RandomState(S + H)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Hkv, D).astype(np.float32)
    v = rng.randn(B, S, Hkv, D).astype(np.float32)
    do = rng.randn(B, S, H, D).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention.attention(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rgrads = vjp(jnp.asarray(do))

    def bhsd(a):
        return torch.from_numpy(a).transpose(1, 2)

    got = flash_attention_backward_plain(bhsd(q), bhsd(k), bhsd(v), bhsd(do),
                                         causal, rows=rows)
    for r, g in zip(rgrads, got):
        r = np.asarray(r)
        assert np.abs(r - g.transpose(1, 2).numpy()).max() \
            <= ATTN_RTOL * np.abs(r).max()


def test_attention_function_backward_equals_plain_autograd():
    """Through ``flash_attention_differentiable`` on CPU tensors (the
    Function the card runs) the gradients equal autograd's of the plain
    version within f32 rounding, and the output equals it exactly."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 33, 16, generator=g)
    k = torch.randn(2, 2, 33, 16, generator=g)
    v = torch.randn(2, 2, 33, 16, generator=g)
    do = torch.randn(2, 8, 33, 16, generator=g)
    outs = []
    for fn in (flash_attention_differentiable, flash_attention_plain):
        leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves_, True)
        outs.append((out.detach(), torch.autograd.grad(out, leaves_, do)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


# ----------------------------------------------------------------- trainer --
@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_trainer_matches_reference(arch):
    """Three steps of each package's ``Trainer`` with the launcher's
    optimizer and two microbatches, on ``synth_lm_batches``."""
    rcfg, rparams, pcfg, pparams = _models(arch)
    batches = port_launch.synth_lm_batches(rcfg.vocab, 4, 32)
    opt = dict(lr=3e-3, schedule="wsd", warmup_steps=20, total_steps=3)
    rt = ref_trainer.Trainer(
        lambda p, b: ref_tf.lm_loss(rcfg, p, b["tokens"], b["labels"])[0],
        rparams, ref_trainer.TrainerConfig(
            opt=ref_optim.OptConfig(**opt), microbatches=2, log_every=1))
    rt.fit(lambda c: {k: jnp.asarray(v) for k, v in batches(c).items()}, 3)
    pt = Trainer(
        lambda p, b: port_tf.lm_loss(pcfg, p, b["tokens"], b["labels"])[0],
        pparams, TrainerConfig(opt=OptConfig(**opt), microbatches=2,
                               log_every=1), device=CPU)
    pt.fit(batches, 3)
    assert len(pt.history) == len(rt.history) == 3
    for r, p in zip(rt.history, pt.history):
        assert abs(p["loss"] / r["loss"] - 1) < LOSS_RTOL
        assert p["lr"] == r["lr"]
    ref = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, rt.params)))
    for k, t in flatten_with_path(pt.params):
        assert np.abs(ref[k] - t.numpy()).max() < PARAM_TOL, k


def test_lm_loss_keeps_one_running_sum_of_drops():
    """``LMLoss`` sums its calls' MoE ``dropped_tokens`` into one 0-d
    tensor, however many steps run: after each of three steps of two
    microbatches, ``take_dropped`` gives the drops of ``lm_loss`` on that
    step's microbatches at the step's params, and clears the sum."""
    _, _, pcfg, pparams = _models("moonshot-v1-16b-a3b")
    batches = port_launch.synth_lm_batches(pcfg.vocab, 4, 32)
    loss = port_tf.LMLoss(pcfg)
    tr = Trainer(loss, pparams, TrainerConfig(opt=OptConfig(lr=3e-3),
                                              microbatches=2), device=CPU)
    total = 0.0
    for step in range(3):
        b = {k: torch.as_tensor(v) for k, v in batches(step).items()}
        with torch.no_grad():
            want = sum(float(port_tf.lm_loss(
                pcfg, tr.params, b["tokens"][i:i + 2],
                b["labels"][i:i + 2])[1]["dropped_tokens"]) for i in (0, 2))
        tr.fit(batches, step + 1)
        assert loss.dropped.dim() == 0
        assert loss.take_dropped() == want
        assert loss.dropped is None
        total += want
    assert total > 0


# ---------------------------------------------------------------- launcher --
def test_synth_batches_equal_reference():
    for cursor in (0, 5):
        r = ref_synth(512, 4, 32)(cursor)
        p = port_launch.synth_lm_batches(512, 4, 32)(cursor)
        for key in ("tokens", "labels"):
            assert np.array_equal(np.asarray(r[key]), p[key])
            assert p[key].dtype == np.int32


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
            "--microbatches", "2", "--arch", "qwen3-moe-235b-a22b",
            "--ckpt-dir", str(tmp_path)]
    trainer = port_launch.main(args)
    assert trainer.step_num == 4
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert "done: 4 steps" in capsys.readouterr().out
    again = port_launch.main(args[:3] + ["6"] + args[4:])
    assert "resumed at step 4" in capsys.readouterr().out
    assert again.step_num == 6


def test_launcher_refuses_mesh_and_other_families():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        port_launch.main(["--device", "cpu", "--mesh", "single"])
    with pytest.raises(SystemExit, match="recsys arch"):
        port_launch.main(["--device", "cpu", "--arch", "dlrm-mlperf"])


# ----------------------------------------------------------------- bundles --
def test_all_cells_equal_reference():
    assert all_cells() == ref_all_cells()
    for arch in ARCH_IDS:
        assert shape_cells(arch) == list(ref_get_bundle(arch).cells)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_lm_bundle_equals_reference(arch, reduced):
    """Cell shapes, microbatches and optimizer of each LM bundle, read
    off the reference bundle's cells (the train step's microbatches are
    checked by running it in ``test_bundle_train_step_matches_reference``)."""
    ref = ref_get_bundle(arch, reduced=reduced)
    port = get_bundle(arch, reduced=reduced)
    assert port.family == ref.family == "lm"
    assert port.config == get_config(arch, reduced=reduced)
    for cell in ("train_4k", "prefill_32k"):
        assert port.shapes[cell] == ref.cells[cell].inputs["batch"]["tokens"].shape
    for cell in ("decode_32k", "long_500k"):
        k = ref.cells[cell].inputs["batch"]["cache"]["k"].shape
        assert port.shapes[cell] == (k[1], k[2])
    assert dataclasses.asdict(port.opt) == dataclasses.asdict(
        ref_optim.OptConfig(**dataclasses.asdict(port.opt)))
    want_mb = {"moonshot-v1-16b-a3b": 8, "qwen3-moe-235b-a22b": 16}
    assert port.microbatches == (1 if reduced else want_mb.get(arch, 4))
    if arch == "minicpm-2b":
        assert port.opt.warmup_steps == 500 and port.opt.lr == 1e-2 / 4


def test_bundle_train_step_matches_reference():
    """The ``train_4k`` cell's step at REDUCED granite, one step from the
    same masters on the same batch, against the reference cell's."""
    ref = ref_get_bundle("granite-3-2b", reduced=True)
    port = get_bundle("granite-3-2b", reduced=True)
    rparams = ref.init(jax.random.PRNGKey(0))
    pparams = transformer_params_from_jax(
        port.config, jax.tree_util.tree_map(np.asarray, rparams), CPU,
        masters=True)
    toks, labels = _batch(port.config.vocab, *port.shapes["train_4k"])
    rp, _, rm = jax.jit(ref.cells["train_4k"].fn)(
        rparams, ref_optim.adamw_init(rparams),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    from repro_torch.train.optim import adamw_init
    pp, _, pm = port.train_step()(
        pparams, adamw_init(pparams),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(pm["loss"]) / float(rm["loss"]) - 1) < 1e-2
    ref_leaves = dict(flatten_with_path(jax.tree_util.tree_map(np.asarray, rp)))
    for k, t in flatten_with_path(pp):
        assert t.dtype == torch.float32
        assert np.abs(ref_leaves[k] - t.numpy()).max() < 1e-5, k


def test_recsys_and_gnn_bundles():
    for arch in RECSYS_ARCH_IDS:
        b = get_bundle(arch, reduced=True)
        assert b.family == "recsys" and list(b.cells) == shape_cells(arch)
        assert b.training.batch_size == b.serving.batch_sizes["train_batch"]
        assert b.config == get_config(arch, reduced=True)
    # the GNN bundle: the reference's cells, per-cell configs and batch
    # shapes at both sizes, and its published dataset sizes
    for reduced in (False, True):
        b, ref = get_bundle("mace", reduced=reduced), ref_get_bundle(
            "mace", reduced=reduced)
        assert b.family == ref.family == "gnn"
        assert list(b.cells) == shape_cells("mace") == list(ref.cells)
        assert b.config == get_config("mace", reduced=reduced)
        assert list(b.cell_configs) == list(ref.cell_configs)
        for cell in b.cells:
            got, want = b.cell_configs[cell], ref.cell_configs[cell]
            assert {f: v for f, v in dataclasses.asdict(got).items()
                    if f != "dtype"} == {
                f: v for f, v in dataclasses.asdict(want).items()
                if f != "dtype"}
            assert {k: (tuple(shape), str(dt).removeprefix("torch."))
                    for k, (shape, dt) in b.cell_specs[cell].inputs.items()
                    } == {k: (tuple(v.shape), str(v.dtype)) for k, v in
                          ref.cells[cell].inputs["batch"].items()}
        assert all(spec.opt == OptConfig(
            lr=1e-3, weight_decay=0.0, schedule="cosine", warmup_steps=10,
            total_steps=1000) for spec in b.cell_specs.values())
    full = get_bundle("mace")
    assert full.sizes["cora"] == (2708, 10556)
    assert full.sizes["products"] == (2_449_029, 61_859_140)
    assert full.cell_specs["minibatch_lg"].inputs["labels"][0] == (169_984,)
    assert full.cell_specs["minibatch_lg"].inputs["edge_mask"][0] == (168_960,)


# ------------------------------------------------ the card phases' helpers --
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _ScaledBackward(torch.autograd.Function):
    """Attention whose backward scales dq by ``factor``: a wrong backward."""
    factor = 2.0

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_plain(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_attention_backward_plain(*ctx.saved_tensors, do,
                                                    ctx.causal)
        return dq * _ScaledBackward.factor, dk, dv, None


def test_chip_lm_grad_check():
    """``chip_smoke``'s kernel-route against plain-route check on REDUCED
    granite in bf16 on the CPU: the ``Function`` passes within
    ``LM_GRAD_LOSS_RTOL`` and ``LM_GRAD_REL_L2``; a backward with dq
    doubled fails it."""
    cs = _chip_smoke()
    pcfg = get_config("granite-3-2b", reduced=True)
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(5),
                                 masters=True)
    names = [n for n, _ in flatten_with_path(params)]
    toks, labels = (torch.from_numpy(a) for a in _batch(pcfg.vocab))
    batch = {"tokens": toks, "labels": labels}
    plain = cs.lm_route_grads(pcfg, params, batch,
                              lambda q, k, v, c: flash_attention_plain(q, k, v, c))
    good = cs.lm_route_grads(pcfg, params, batch,
                             flash_attention_differentiable)
    check, failures = cs.lm_grad_failures(good, plain, names)
    assert failures == [] and check["max_rel_l2"] < cs.LM_GRAD_REL_L2
    bad = cs.lm_route_grads(pcfg, params, batch, _ScaledBackward.apply)
    _, failures = cs.lm_grad_failures(bad, plain, names)
    assert any("wq" in f for f in failures)


def test_chip_moe_parity_helpers():
    """``chip_smoke.teacher_forced`` on REDUCED Moonshot in f32, with the
    CPU on both sides: identical logits, stats, tokens, expert picks and
    drops, so ``parity_failures`` finds nothing; a different drop count
    or expert pick is reported."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", reduced=True),
                              dtype=torch.float32)
    params = port_tf.init_params(cfg, torch.Generator().manual_seed(2))
    specs = cs.parity_specs(cfg.vocab, 15)[:2]
    kw = dict(batch_slots=2, s_max=256, page_size=16, chain_limit=3)
    run = cs.teacher_forced(cfg, params, torch.device(CPU), (), specs, kw)
    assert run["moe_calls"] > 0 and run["same_experts"]
    assert max(run["errs"]) == 0.0
    assert cs.parity_failures("p", run, {}) == []
    run["dropped"] = [run["dropped"][0], run["dropped"][0] + 1]
    run["same_experts"] = False
    failures = cs.parity_failures("p", run, {})
    assert len(failures) == 2
