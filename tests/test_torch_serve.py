"""The port's LM serving slice against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` and cross over as numpy
arrays (``transformer_params_from_jax``), so both packages serve the same
model.  Tolerances: f32 logits and caches to 1e-4 — the two sides sum the
same products in other orders (XLA's CPU dots and the port's flash and
paged plain versions against PyTorch's), which moves f32 results by about
1e-6 at these widths, and 1e-4 leaves a wide margin; bf16 to 5e-2, where
the two sides also round to bf16 at other places (the port keeps
attention's ``p @ v`` in f32).  The engine's tokens and ``stats()`` must
be identical in f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_bundle
from repro.core.paged_kv import PagedKVManager as RefPagedKVManager
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch.configs.registry import (
    ARCH_IDS,
    LM_ARCH_IDS,
    RECSYS_ARCH_IDS,
    SERVE_ARCH_IDS,
    get_config,
)
from repro_torch.convert import transformer_params_from_jax
from repro_torch.core.paged_kv import PagedKVManager
from repro_torch.launch import serve as port_launch
from repro_torch.models import transformer as port_tf
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401,E402

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _models(arch: str, dtype: str):
    """(reference cfg, reference params, port cfg, port params)."""
    jd, td, _ = DTYPES[dtype]
    rcfg = dataclasses.replace(get_bundle(arch, reduced=True).config, dtype=jd)
    rparams = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_config(arch, reduced=True), dtype=td)
    pparams = transformer_params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, rparams), CPU)
    return rcfg, rparams, pcfg, pparams


def _err(j, t) -> float:
    return float(np.abs(np.asarray(jnp.asarray(j, jnp.float32))
                        - t.float().numpy()).max())


def _ref_layout(kc: torch.Tensor) -> torch.Tensor:
    """The port's head-major (L, B, n_kv, S, D) cache in the reference's
    (L, B, S, n_kv, D) layout."""
    return kc.permute(0, 1, 3, 2, 4)


# ------------------------------------------------------------ transformer --
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", SERVE_ARCH_IDS)
def test_prefill_and_decode_match_reference(arch, dtype):
    rcfg, rparams, pcfg, pparams = _models(arch, dtype)
    tol = DTYPES[dtype][2]
    B, S, s_max = 2, 12, 32
    tokens = np.random.RandomState(5).randint(0, rcfg.vocab, (B, S))

    rlog, rcache = ref_tf.prefill(rcfg, rparams, jnp.asarray(tokens, jnp.int32))
    plog, pcache = port_tf.prefill(pcfg, pparams, torch.from_numpy(tokens))
    assert plog.shape == (B, rcfg.vocab) and plog.dtype == pcfg.dtype
    assert _err(rlog, plog) < tol
    for key in ("k", "v"):
        assert _err(rcache[key], _ref_layout(pcache[key])) < tol
    assert np.array_equal(np.asarray(rcache["len"]), pcache["len"].numpy())

    # slot caches with ragged lengths: row 1 rewinds three tokens
    lens = np.array([S, S - 3], np.int32)
    rc = ref_tf.make_cache(rcfg, B, s_max)
    rc["k"] = rc["k"].at[:, :, :S].set(rcache["k"])
    rc["v"] = rc["v"].at[:, :, :S].set(rcache["v"])
    rc["len"] = jnp.asarray(lens)
    pc = port_tf.make_cache(pcfg, B, s_max, page_size=8, device=CPU)
    pc["k"][:, :, :, :S] = pcache["k"]
    pc["v"][:, :, :, :S] = pcache["v"]
    pc["len"] = torch.from_numpy(lens)
    step = jax.jit(lambda p, t, c: ref_tf.decode_step(rcfg, p, t, c))
    tok = np.asarray(jnp.argmax(rlog, axis=-1))
    for _ in range(3):
        rlog, rc = step(rparams, jnp.asarray(tok, jnp.int32), rc)
        plog, pc = port_tf.decode_step(pcfg, pparams, torch.tensor(tok), pc)
        assert _err(rlog, plog) < tol
        assert np.array_equal(np.asarray(rc["len"]), pc["len"].numpy())
        for key in ("k", "v"):
            assert _err(rc[key], _ref_layout(pc[key])) < tol
        tok = np.asarray(jnp.argmax(rlog, axis=-1))


def test_decode_leaves_a_full_row_unwritten():
    """At len == S_max the reference's one-hot select writes nothing; the
    port's in-place write leaves the row as it was too."""
    _, _, pcfg, pparams = _models("granite-3-2b", "f32")
    pc = port_tf.make_cache(pcfg, 2, 16, page_size=8, device=CPU)
    pc["k"].normal_(generator=torch.Generator().manual_seed(0))
    pc["len"] = torch.tensor([16, 4], dtype=torch.int32)
    before = pc["k"][:, 0].clone()
    _, pc = port_tf.decode_step(pcfg, pparams, torch.tensor([1, 2]), pc)
    assert torch.equal(pc["k"][:, 0], before)
    assert not torch.equal(pc["k"][:, 1, :, 4], torch.zeros_like(pc["k"][:, 1, :, 4]))
    assert pc["len"].tolist() == [17, 5]


@pytest.mark.parametrize("arch", SERVE_ARCH_IDS)
def test_init_params_mirror_reference_structure(arch):
    rcfg = get_bundle(arch, reduced=True).config
    shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape),
        ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    pcfg = get_config(arch, reduced=True)
    params = port_tf.init_params(pcfg, torch.Generator().manual_seed(0))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert got == shapes
    assert params["block"]["wq"]["w"].dtype == pcfg.dtype
    assert params["block"]["ln1"].dtype == torch.float32
    again = port_tf.init_params(pcfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


# ----------------------------------------------------------------- engine --
def _scenario_requests(name, vocab, cls):
    if name == "bounded_kv":
        rng = np.random.RandomState(0)
        return [cls(req_id=i,
                    prompt=rng.randint(0, vocab, 16).astype(np.int32),
                    max_new_tokens=8) for i in range(7)]
    prompt = np.arange(12, dtype=np.int32) % vocab
    return [cls(req_id=0, prompt=prompt, max_new_tokens=6)]


SCENARIOS = {  # the two scenarios of tests/test_serve.py
    "bounded_kv": dict(batch_slots=3, s_max=96, page_size=8, chain_limit=3),
    "deterministic": dict(batch_slots=2, s_max=64, page_size=8),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("arch", SERVE_ARCH_IDS)
def test_engine_matches_reference(arch, scenario):
    rcfg, rparams, pcfg, pparams = _models(arch, "f32")
    kw = SCENARIOS[scenario]
    ref = RefServeEngine(rcfg, rparams, **kw)
    port = ServeEngine(pcfg, pparams, device=CPU, **kw)
    for r in _scenario_requests(scenario, rcfg.vocab, RefRequest):
        ref.submit(r)
    for r in _scenario_requests(scenario, rcfg.vocab, Request):
        port.submit(r)
    ref_done = ref.run_until_done(max_steps=200)
    port_done = port.run_until_done(max_steps=200)
    assert [r.req_id for r in port_done] == [r.req_id for r in ref_done]
    for r, p in zip(ref_done, port_done):
        assert p.out_tokens == r.out_tokens, r.req_id
        assert p.done and r.done
    assert port.steps == ref.steps
    assert port.stats() == ref.stats()
    if scenario == "bounded_kv":
        assert port.stats()["kv"]["max_gather_depth"] <= 3
        assert port.steps < 7 * 8


def test_launcher_serves_on_the_cpu(capsys):
    stats = port_launch.main(["--device", "cpu", "--requests", "3",
                              "--slots", "2", "--prompt-len", "10",
                              "--max-new", "4"])
    assert stats["steps"] == 6   # two waves of four tokens, one overlapping
    assert "3 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------- paged-KV copy --
def _managers(**kw):
    return RefPagedKVManager(**kw), PagedKVManager(**kw)


def _same_state(ref, port, seqs):
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.free_pages == ref.free_pages
    assert port.fragmentation() == ref.fragmentation()
    for s in seqs:
        assert port.page_ids(s) == ref.page_ids(s)
        assert port.gather_depth(s) == ref.gather_depth(s)
    if seqs:
        width = max(len(port.page_ids(s)) for s in seqs) + 1
        assert np.array_equal(port.block_table(seqs, width),
                              ref.block_table(seqs, width))
        assert np.array_equal(port.lengths(seqs), ref.lengths(seqs))


@pytest.mark.parametrize("case", ["bounded_depth", "sr_invariant",
                                  "free_and_reuse", "random_limits"])
def test_paged_kv_manager_matches_reference(case):
    """The operation sequences of tests/test_paged_kv.py, applied to both
    managers step by step."""
    if case == "bounded_depth":
        ref, port = _managers(n_pages=1024, page_size=16, chain_limit=4)
        seqs = list(range(8))
        for m in (ref, port):
            for s in seqs:
                m.new_sequence(s)
        rng = np.random.RandomState(0)
        for _ in range(400):
            s, n = int(rng.randint(8)), int(rng.randint(1, 40))
            ref.append_tokens(s, n)
            port.append_tokens(s, n)
            _same_state(ref, port, [s])
        assert port.stats.compactions > 0
    elif case == "sr_invariant":
        ref, port = _managers(n_pages=128, page_size=16, chain_limit=9)
        seqs = [0]
        ref.new_sequence(0)
        port.new_sequence(0)
        rng = np.random.RandomState(1)
        for _ in range(50):
            n = int(rng.randint(1, 23))
            ref.append_tokens(0, n)
            port.append_tokens(0, n)
            assert (port.seqs[0].length, port.seqs[0].tail) == \
                (ref.seqs[0].length, ref.seqs[0].tail)
    elif case == "free_and_reuse":
        ref, port = _managers(n_pages=64, page_size=8, chain_limit=3)
        for m in (ref, port):
            for s in range(4):
                m.new_sequence(s)
                m.append_tokens(s, 64)
            for s in range(4):
                m.free_sequence(s)
            m.new_sequence(9)
            m.append_tokens(9, 64 * 8)
        seqs = [9]
    else:
        rng = np.random.RandomState(2)
        for limit in range(2, 10):
            ref, port = _managers(n_pages=4096, page_size=8, chain_limit=limit)
            seqs = []
            for _ in range(int(rng.randint(1, 80))):
                s, n = int(rng.randint(0, 6)), int(rng.randint(1, 34))
                if s not in seqs:
                    seqs.append(s)
                    ref.new_sequence(s)
                    port.new_sequence(s)
                ref.append_tokens(s, n)
                port.append_tokens(s, n)
            _same_state(ref, port, seqs)
    _same_state(ref, port, seqs)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", SERVE_ARCH_IDS)
def test_configs_equal_reference(arch, reduced):
    ref = get_bundle(arch, reduced=reduced).config
    port = get_config(arch, reduced=reduced)
    for f in dataclasses.fields(port):
        if f.name == "dtype":
            assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.params_dense == ref.params_dense


def test_unported_archs_raise():
    """Every arch id is ported now (the GNN id last): each resolves to its
    config, and only an unknown id raises."""
    assert set(SERVE_ARCH_IDS) < set(ARCH_IDS)
    rest = set(ARCH_IDS) - set(LM_ARCH_IDS) - set(RECSYS_ARCH_IDS)
    assert rest == {"mace"}
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_serve_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means the card; without one the serving entry
    points raise instead of running on the CPU."""
    _, _, pcfg, pparams = _models("granite-3-2b", "f32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(pcfg, pparams)
    with pytest.raises(RuntimeError):
        port_tf.make_cache(pcfg, 1, 16)
    with pytest.raises(RuntimeError):
        transformer_params_from_jax(pcfg, {})
    with pytest.raises(RuntimeError):
        port_launch.main(["--requests", "1"])
