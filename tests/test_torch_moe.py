"""The port's MoE layer and MoE serving against the JAX package, on the CPU.

Tolerances:
  * dispatch, given the same gates: exact.  Both packages take the top-k
    by repeated argmax (first index on a tie), count slots with the same
    f32 cumsums of 0/1 values (exact below 2^24), and place a pick only by
    comparisons of those integers, so nothing rounds;
  * ``moe_apply`` in f32: 1e-5 absolute on outputs of about unit size
    (the two sides sum the same f32 products in other orders, which moves
    them by about 1e-7).  The router's gates are computed by each side,
    so a top-k pick could flip where two gates tie within rounding; the
    inputs' smallest gap between neighbouring gates is asserted to exceed
    that tolerance, so that a flip fails the test instead of passing as
    noise;
  * ``prefill`` and ``decode_step`` logits and caches in f32: 1e-4, as in
    ``test_torch_serve.py``; the engine's tokens and ``stats()``: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch.configs.registry import MOE_ARCH_IDS, get_config
from repro_torch.convert import transformer_params_from_jax
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as port_tf
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4


def _gates(G, T, E, seed):
    logits = np.random.RandomState(seed).randn(G, T, E).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------- dispatch --
@pytest.mark.parametrize("top_k,capacity", [(1, 3), (2, 1), (2, 5), (3, 8),
                                            (2, 64)])
def test_top_k_dispatch_equals_reference(top_k, capacity):
    g = _gates(2, 32, 8, seed=capacity)
    rd, rc, ra = ref_moe._top_k_dispatch(jnp.asarray(g), top_k, capacity)
    pd, pc, pa = port_moe._top_k_dispatch(torch.from_numpy(g), top_k, capacity)
    assert np.array_equal(np.asarray(rd), pd.numpy())
    assert np.array_equal(np.asarray(rc), pc.numpy())
    assert float(ra["dropped_tokens"]) == float(pa["dropped_tokens"])
    assert pa["experts"].shape == (2, 32, top_k)


@pytest.mark.parametrize("top_k,capacity", [(1, 3), (2, 1), (2, 5), (3, 8),
                                            (2, 64)])
def test_sort_slots_equal_reference_dispatch(top_k, capacity):
    """The sort route's slots and keeps, rebuilt into a (G, T, E, C)
    dispatch tensor, equal the reference's one-hot dispatch on the same
    gates: the same pick lands in the same slot, the same picks drop."""
    G, T, E = 2, 32, 8
    g = _gates(G, T, E, seed=capacity)
    rd, _, ra = ref_moe._top_k_dispatch(jnp.asarray(g), top_k, capacity)
    sl = port_moe._sort_slots(torch.from_numpy(g), top_k, capacity)
    built = np.zeros((G, T, E * capacity + 1), np.float32)
    rows = np.arange(G)[:, None].repeat(T * top_k, 1)
    np.add.at(built, (rows, sl["t"].numpy(), sl["slot"].numpy()), 1.0)
    assert built[..., E * capacity].sum() == float(ra["dropped_tokens"])
    assert np.array_equal(
        built[..., : E * capacity].reshape(G, T, E, capacity), np.asarray(rd))
    assert float(sl["dropped"]) == float(ra["dropped_tokens"])
    assert int(sl["keep"].sum()) == int(np.asarray(rd).sum())


# ------------------------------------------------------------- moe_apply --
def _layer_np(d, cfg, seed, router_scale=0.5):
    """One layer's weights, numpy f32 in the reference's structure; the
    router wide enough that the gates keep clear of ties."""
    rng = np.random.RandomState(seed)
    E, F = cfg.n_experts, cfg.d_ff

    def n(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    p = {"router": {"w": n(d, E, scale=router_scale / np.sqrt(d))},
         "wg": n(E, d, F, scale=d ** -0.5), "wu": n(E, d, F, scale=d ** -0.5),
         "wd": n(E, F, d, scale=F ** -0.5)}
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        p["shared"] = {"wg": n(d, Fs, scale=d ** -0.5),
                       "wu": n(d, Fs, scale=d ** -0.5),
                       "wd": n(Fs, d, scale=Fs ** -0.5)}
    return p


def _min_gate_gap(p, x, top_k):
    """The smallest gap between neighbouring gates among each token's
    top k + 1 (a flip of any of those order pairs changes the routing
    or the pick's priority)."""
    logits = x.reshape(-1, x.shape[-1]) @ p["router"]["w"]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    g = -np.sort(-(e / e.sum(-1, keepdims=True)), axis=-1)[:, : top_k + 1]
    return float((g[:, :-1] - g[:, 1:]).min())


MOE_CASES = {
    "roomy": dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=4.0),
    "tight": dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=0.5),
    "shared": dict(n_experts=8, top_k=2, d_ff=32, n_shared_experts=1,
                   capacity_factor=1.0),
    "groups": dict(n_experts=4, top_k=3, d_ff=24, n_shared_experts=2,
                   capacity_factor=1.25, group_tokens=24),
}


def _moe_inputs(case, dispatch):
    cfg = dict(MOE_CASES[case], dispatch=dispatch)
    rcfg, pcfg = ref_moe.MoEConfig(**cfg), port_moe.MoEConfig(**cfg)
    d = 48
    p = _layer_np(d, rcfg, seed=len(case))
    x = np.random.RandomState(7).randn(2, 36, d).astype(np.float32)
    return rcfg, pcfg, p, x


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case, dispatch):
    rcfg, pcfg, p, x = _moe_inputs(case, dispatch)
    assert _min_gate_gap(p, x, rcfg.top_k) > MOE_TOL
    ry, ra = ref_moe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), rcfg, dtype=jnp.float32)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    py, pa = port_moe.moe_apply(tp, torch.from_numpy(x), pcfg,
                                dtype=torch.float32)
    assert py.shape == x.shape and py.dtype == torch.float32
    assert np.abs(np.asarray(ry) - py.numpy()).max() < MOE_TOL
    assert float(pa["dropped_tokens"]) == float(ra["dropped_tokens"])
    assert abs(float(pa["balance_loss"]) - float(ra["balance_loss"])) < 1e-6
    if case == "roomy":
        assert float(pa["dropped_tokens"]) == 0
    if case == "tight":
        assert float(pa["dropped_tokens"]) > 0


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_routes_agree_in_both_packages(case):
    """The sort route computes the one-hot route's function: same output
    within MOE_TOL and the same drops, in each package."""
    rcfg, pcfg, p, x = _moe_inputs(case, "onehot")
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    ys = {}
    for dispatch in ("onehot", "sort"):
        ry, ra = ref_moe.moe_apply(
            jp, jnp.asarray(x), dataclasses.replace(rcfg, dispatch=dispatch),
            dtype=jnp.float32)
        py, pa = port_moe.moe_apply(
            tp, torch.from_numpy(x),
            dataclasses.replace(pcfg, dispatch=dispatch), dtype=torch.float32)
        ys[dispatch] = (np.asarray(ry), py.numpy(), float(ra["dropped_tokens"]),
                        float(pa["dropped_tokens"]))
    for side in (0, 1):
        assert np.abs(ys["onehot"][side] - ys["sort"][side]).max() < MOE_TOL
    assert ys["onehot"][2] == ys["sort"][2] == ys["onehot"][3] == ys["sort"][3]


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_gradients_match_reference(dispatch):
    """Autograd through the port's layer against ``jax.grad`` of the
    reference's, in f32: every weight's gradient and the input's within
    1e-5 of the largest of its elements."""
    rcfg, pcfg, p, x = _moe_inputs("shared", dispatch)

    def rloss(pp, xx):
        y, aux = ref_moe.moe_apply(pp, xx, rcfg, dtype=jnp.float32)
        return jnp.sum(y ** 2) + aux["balance_loss"]

    rg = jax.grad(rloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = port_moe.moe_apply(tp, tx, pcfg, dtype=torch.float32)
    (torch.sum(y ** 2) + aux["balance_loss"]).backward()
    pairs = list(zip(jax.tree_util.tree_leaves(rg[0]),
                     jax.tree_util.tree_leaves(tp))) + [(rg[1], tx)]
    for r, t in pairs:
        r = np.asarray(r)
        assert np.abs(r - t.grad.numpy()).max() <= 1e-5 * np.abs(r).max()


def test_moe_init_structure_and_dtypes():
    cfg = port_moe.MoEConfig(n_experts=4, top_k=2, d_ff=16,
                             n_shared_experts=2)
    ref = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        ref_moe.moe_init(jax.random.PRNGKey(0), 32, ref_moe.MoEConfig(
            n_experts=4, top_k=2, d_ff=16, n_shared_experts=2)))
    p = port_moe.moe_init(torch.Generator().manual_seed(0), 32, cfg,
                          dtype=torch.bfloat16)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), p) == ref
    assert p["router"]["w"].dtype == torch.float32
    assert p["wg"].dtype == p["shared"]["wd"].dtype == torch.bfloat16


def test_decode_capacity_at_sixteen_slots():
    """A 16-slot decode step of Moonshot's MoE is one group of 16 tokens
    with capacity max(1, int(16 * 6 * 1.25 / 64)) = 1 an expert: every row
    competes for it, empty slots too, and the reference drops the same
    picks."""
    cfg = get_config("moonshot-v1-16b-a3b").moe
    d = 64
    small = dataclasses.replace(cfg, d_ff=8)
    p = _layer_np(d, small, seed=3)
    x = np.random.RandomState(4).randn(16, 1, d).astype(np.float32)
    _, ra = ref_moe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), ref_moe.MoEConfig(
                                  **dataclasses.asdict(small)),
                              dtype=jnp.float32)
    _, pa = port_moe.moe_apply(jax.tree_util.tree_map(torch.from_numpy, p),
                               torch.from_numpy(x), small, dtype=torch.float32)
    assert max(1, int(16 * cfg.top_k * cfg.capacity_factor / cfg.n_experts)) == 1
    assert float(pa["dropped_tokens"]) == float(ra["dropped_tokens"]) > 0


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_moe_configs_equal_reference(arch, reduced):
    ref = get_bundle(arch, reduced=reduced).config
    port = get_config(arch, reduced=reduced)
    for f in dataclasses.fields(port):
        if f.name == "dtype":
            assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        elif f.name == "moe":
            assert dataclasses.asdict(port.moe) == dataclasses.asdict(ref.moe)
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.params_dense == ref.params_dense
    assert port.params_active == ref.params_active
    if arch == "moonshot-v1-16b-a3b" and not reduced:
        assert port.params_dense == 28_552_923_136
        assert port.params_active == 4_462_938_112


# ------------------------------------------------------------ transformer --
def _models(arch: str):
    """(reference cfg, reference params, port cfg, port params) in f32."""
    rcfg = dataclasses.replace(get_bundle(arch, reduced=True).config,
                               dtype=jnp.float32)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype=torch.float32)
    pparams = transformer_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), CPU)
    return rcfg, rparams, pcfg, pparams


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_init_params_mirror_reference_structure(arch):
    rcfg = get_bundle(arch, reduced=True).config
    shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    pcfg = get_config(arch, reduced=True)
    for masters in (False, True):
        params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0),
                                     masters=masters)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
        moe = params["block"]["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        want = torch.float32 if masters else pcfg.dtype
        assert moe["wg"].dtype == params["block"]["wq"]["w"].dtype == want


def test_convert_keeps_the_router_f32():
    rcfg = get_bundle("moonshot-v1-16b-a3b", reduced=True).config
    rparams = jax.tree_util.tree_map(
        np.asarray, ref_tf.init_params(rcfg, jax.random.PRNGKey(1)))
    pcfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    p = transformer_params_from_jax(pcfg, rparams, CPU)
    moe = p["block"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert np.array_equal(moe["router"]["w"].numpy(),
                          rparams["block"]["moe"]["router"]["w"])
    assert moe["wg"].dtype == moe["shared"]["wu"].dtype == torch.bfloat16
    assert tuple(moe["wd"].shape) == rparams["block"]["moe"]["wd"].shape
    m = transformer_params_from_jax(pcfg, rparams, CPU, masters=True)
    assert m["block"]["moe"]["wg"].dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, rparams, pcfg, pparams = _models(arch)
    B, S, s_max = 2, 12, 32
    tokens = np.random.RandomState(5).randint(0, rcfg.vocab, (B, S))
    rlog, rcache = ref_tf.prefill(rcfg, rparams, jnp.asarray(tokens, jnp.int32))
    plog, pcache = port_tf.prefill(pcfg, pparams, torch.from_numpy(tokens))
    assert _err(rlog, plog) < LOGIT_TOL
    for key in ("k", "v"):
        assert _err(rcache[key], pcache[key].permute(0, 1, 3, 2, 4)) < LOGIT_TOL
    assert pcache["moe_dropped"].dtype == torch.float32

    lens = np.array([S, S - 3], np.int32)
    rc = ref_tf.make_cache(rcfg, B, s_max)
    rc["k"] = rc["k"].at[:, :, :S].set(rcache["k"])
    rc["v"] = rc["v"].at[:, :, :S].set(rcache["v"])
    rc["len"] = jnp.asarray(lens)
    pc = port_tf.make_cache(pcfg, B, s_max, page_size=8, device=CPU)
    pc["k"][:, :, :, :S] = pcache["k"]
    pc["v"][:, :, :, :S] = pcache["v"]
    pc["len"] = torch.from_numpy(lens)
    tok = np.asarray(jnp.argmax(rlog, axis=-1))
    for _ in range(3):
        rlog, rc = ref_tf.decode_step(rcfg, rparams, jnp.asarray(tok, jnp.int32), rc)
        plog, pc = port_tf.decode_step(pcfg, pparams, torch.tensor(tok), pc)
        assert _err(rlog, plog) < LOGIT_TOL
        for key in ("k", "v"):
            assert _err(rc[key], pc[key].permute(0, 1, 3, 2, 4)) < LOGIT_TOL
        tok = np.asarray(jnp.argmax(rlog, axis=-1))


SCENARIOS = {  # the two scenarios of tests/test_serve.py
    "bounded_kv": dict(batch_slots=3, s_max=96, page_size=8, chain_limit=3),
    "deterministic": dict(batch_slots=2, s_max=64, page_size=8),
}


def _requests(name, vocab, cls):
    if name == "bounded_kv":
        rng = np.random.RandomState(0)
        return [cls(req_id=i, prompt=rng.randint(0, vocab, 16).astype(np.int32),
                    max_new_tokens=8) for i in range(7)]
    return [cls(req_id=0, prompt=np.arange(12, dtype=np.int32) % vocab,
                max_new_tokens=6)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", MOE_ARCH_IDS)
def test_engine_matches_reference(arch, scenario):
    rcfg, rparams, pcfg, pparams = _models(arch)
    kw = SCENARIOS[scenario]
    ref = RefServeEngine(rcfg, rparams, **kw)
    port = ServeEngine(pcfg, pparams, device=CPU, **kw)
    for r in _requests(scenario, rcfg.vocab, RefRequest):
        ref.submit(r)
    for r in _requests(scenario, rcfg.vocab, Request):
        port.submit(r)
    ref_done = ref.run_until_done(max_steps=200)
    port_done = port.run_until_done(max_steps=200)
    assert [r.req_id for r in port_done] == [r.req_id for r in ref_done]
    for r, p in zip(ref_done, port_done):
        assert p.out_tokens == r.out_tokens, r.req_id
    assert port.steps == ref.steps
    assert port.stats() == ref.stats()
