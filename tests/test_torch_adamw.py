"""The fused AdamW kernel (``csrc/adamw.cu``) and its wrapper
(``kernels/adamw/kernel.py``).

On the CPU:

  * the wrapper raises on what the kernel does not take (operands on two
    devices, strided operands, other dtypes, a gradient of another dtype
    than its leaf, other shapes, scalars that are not 0-d f32), on
    either device;
  * its ctypes argtypes equal the C entry point's signature;
  * an f32 numpy emulation of the source's ``update`` (each operation
    rounded once, in its order; bf16 rounded to nearest even) equals the
    plain version bit for bit: the order the kernel computes in is the
    plain version's;
  * ``adamw_cost`` counts 28 bytes an f32 element, and a dry run of
    DLRM's REDUCED train step charges one ``adamw`` launch a leaf at its
    bytes.

On the card (skipped without one): the kernel's p, mu and nu equal the
plain version's bit for bit (p and g both f32 or both bf16, donated or not,
lengths that are no multiple of 4 or 8, offset views, the clip active,
steps 1 and 1,000), and ``Trainer.fit`` on REDUCED DLRM launches it once
a leaf a step (marked ``card``, the marker ``bench/tests/conftest.py``
registers).  This file imports no JAX, so it runs as it is on the card:
``python -m pytest tests/test_torch_adamw.py``.
"""

import ctypes
import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_bundle, get_training
from repro_torch.device import dry_running
from repro_torch.kernels.adamw import ADAMW, adamw_leaf, adamw_leaf_plain
from repro_torch.kernels.costs import adamw_cost
from repro_torch.launch import dryrun
from repro_torch.train.optim import OptConfig
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "adamw.cu"
OPT = OptConfig()
HYPER = dict(b1=OPT.b1, b2=OPT.b2, eps=OPT.eps,
             weight_decay=OPT.weight_decay)
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


def _scalars(step: int, scale: float, device="cpu"):
    """``scale``, ``lr``, ``bc1``, ``bc2`` as ``adamw_update`` makes them:
    0-d f32 tensors, the corrections from an f32 step."""
    s = torch.tensor(float(step), device=device)
    return (torch.tensor(scale, device=device),
            torch.tensor(3e-4, device=device) * torch.clamp(s / 100, max=1.0),
            1 - OPT.b1 ** s, 1 - OPT.b2 ** s)


def _leaf(n: int, dtype, step: int, seed: int = 0):
    """p and g of ``dtype``, and f32 mu and nu, of ``n`` elements on the
    CPU; zero moments at step 1, moments of a long run (nu >= 0) at a
    later step."""
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=gen).to(dtype)
    g = (torch.randn(n, generator=gen) * 3).to(dtype)
    if step == 1:
        mu, nu = torch.zeros(n), torch.zeros(n)
    else:
        mu = torch.randn(n, generator=gen) * 0.1
        nu = torch.rand(n, generator=gen) * 0.01
    return p, g, mu, nu


# ------------------------------------------------------ what it refuses --
def _bad(case: str):
    p, g, mu, nu = _leaf(12, F32, 1)
    ops = {"p": p, "g": g, "mu": mu, "nu": nu}
    scal = list(_scalars(1, 0.5))
    if case == "strided p":
        ops["p"] = torch.zeros(24)[::2]
    elif case == "strided g":
        ops["g"] = torch.zeros(12, 2)[:, 0]
    elif case == "transposed mu":
        ops = {k: v.reshape(3, 4) for k, v in ops.items()}
        ops["mu"] = torch.zeros(4, 3).t()
    elif case == "f16 p":
        ops["p"] = p.half()
    elif case == "f64 g":
        ops["g"] = g.double()
    elif case == "bf16 g beside f32 p":
        ops["g"] = g.bfloat16()
    elif case == "f32 g beside bf16 p":
        ops["p"] = p.bfloat16()
    elif case == "bf16 mu":
        ops["mu"] = mu.bfloat16()
    elif case == "f64 nu":
        ops["nu"] = nu.double()
    elif case == "shape of g":
        ops["g"] = torch.zeros(13)
    elif case == "shape of nu":
        ops["nu"] = torch.zeros(3, 4)
    elif case == "scale of 1 element, 1-d":
        scal[0] = scal[0].reshape(1)
    elif case == "f64 lr":
        scal[1] = scal[1].double()
    elif case == "bc1 a float":
        scal[2] = 0.1
    return ops, scal


REFUSED = {"strided p": ValueError, "strided g": ValueError,
           "transposed mu": ValueError, "f16 p": TypeError,
           "f64 g": TypeError, "bf16 g beside f32 p": TypeError,
           "f32 g beside bf16 p": TypeError, "bf16 mu": TypeError,
           "f64 nu": TypeError,
           "shape of g": ValueError, "shape of nu": ValueError,
           "scale of 1 element, 1-d": TypeError, "f64 lr": TypeError,
           "bc1 a float": TypeError}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    ops, scal = _bad(case)
    with pytest.raises(REFUSED[case]):
        adamw_leaf(ops["p"], ops["g"], ops["mu"], ops["nu"], *scal,
                   donate=False, **HYPER)


def test_operands_on_two_devices_are_refused():
    """A meta g beside CPU p inside a dry run (where meta stands for the
    card), and a meta operand outside one."""
    p, g, mu, nu = _leaf(8, F32, 1)
    meta_g = torch.empty(8, device="meta")
    with dry_running(dryrun.Count({}, None)):
        with pytest.raises(ValueError, match="several devices"):
            adamw_leaf(p, meta_g, mu, nu, *_scalars(1, 1.0), donate=True,
                       **HYPER)
        meta_scale = torch.tensor(1.0, device="meta")
        with pytest.raises(ValueError, match="several devices"):
            adamw_leaf(p, g, mu, nu, meta_scale, *_scalars(1, 1.0)[1:],
                       donate=True, **HYPER)
    with pytest.raises(ValueError, match="unsupported device"):
        adamw_leaf(p, meta_g, mu, nu, *_scalars(1, 1.0), donate=True,
                   **HYPER)


# ------------------------------------------------ the C entry's binding --
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def test_argtypes_match_the_c_signature():
    text = SOURCE.read_text()
    m = re.search(r'extern "C" int ' + ADAMW.symbol + r"\((.*?)\)\s*\{",
                  text, re.S)
    assert m and text.count('extern "C"') == 1
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params]
    assert params[-1] == "void* stream"
    assert ADAMW.argtypes == types[:-1]


# -------------------------------------- the kernel's arithmetic, emulated --
def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 to bf16 (as the high half of an f32), rounded to nearest even."""
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


def _emulate(p, g, mu, nu, scale, lr, bc1, bc2, p_bf16: bool):
    """``csrc/adamw.cu``'s ``update`` in numpy f32: every operation
    rounded once, in the source's order, on the constants as the C entry
    point receives them (each Python float rounded once to f32)."""
    f = np.float32
    b1, b2 = f(OPT.b1), f(OPT.b2)
    c1, c2 = f(1 - OPT.b1), f(1 - OPT.b2)
    eps, wd = f(OPT.eps), f(OPT.weight_decay)
    g = g * scale
    mu = mu * b1 + c1 * g
    nu = nu * b2 + (c2 * g) * g
    den = np.sqrt(nu / bc2) + eps
    upd = lr * ((mu / bc1) / den + wd * p)
    p = p - upd
    return (_bf16_bits(p) if p_bf16 else p), mu, nu


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_kernels_order_of_operations_is_the_plain_versions(dtype):
    p, g, mu, nu = _leaf(4099, dtype, 1000, seed=3)
    scal = _scalars(1000, 0.37)
    want = _emulate(*(t.float().numpy() for t in (p, g, mu, nu)),
                    *(np.float32(t.item()) for t in scal),
                    p_bf16=dtype == BF16)
    got = adamw_leaf(p, g, mu, nu, *scal, donate=False, **HYPER)
    for w, t in zip(want, got):
        assert np.array_equal(t.float().numpy().view(np.uint32),
                              w.view(np.uint32))


@pytest.mark.parametrize("p_dtype", [F32, BF16])
def test_on_the_cpu_the_wrapper_is_the_plain_version(p_dtype):
    """Donated or not, bit for bit, and no launch counted."""
    before = ADAMW.launches
    p, g, mu, nu = _leaf(1001, p_dtype, 1000)
    scal = _scalars(1000, 0.5)
    want = adamw_leaf_plain(p.clone(), g, mu.clone(), nu.clone(), *scal,
                            donate=False, **HYPER)
    fresh = adamw_leaf(p, g, mu, nu, *scal, donate=False, **HYPER)
    donated = adamw_leaf(p, g, mu, nu, *scal, donate=True, **HYPER)
    assert donated[0] is p and donated[1] is mu and donated[2] is nu
    for w, a, b in zip(want, fresh, donated):
        assert torch.equal(w, a) and torch.equal(w, b)
    assert ADAMW.launches == before


# ------------------------------------------------ the bytes and the dry run --
def test_adamw_cost_counts_each_operand_once():
    assert adamw_cost(10, F32, F32).nbytes == 280
    assert adamw_cost(10, BF16, BF16).nbytes == 220
    assert adamw_cost(10, BF16, F32).nbytes == 240
    assert adamw_cost(10, F32, F32).flops == 0
    assert adamw_cost(10 ** 9, F32, F32).bound_by() == "bytes"


def test_a_dry_run_of_dlrm_reduced_charges_one_launch_a_leaf():
    bundle = get_bundle("dlrm-mlperf", reduced=True)
    r = dryrun.run(bundle, "train_batch", (1, 1), ("data", "model"))
    params = leaves(bundle.abstract_params())
    assert r["ok"]
    assert r["kernels"]["adamw"] == {
        "launches": len(params), "flops": 0.0,
        "bytes": sum(adamw_cost(p.numel(), p.dtype, p.dtype).nbytes
                     for p in params)}
    assert len(params) > 10


# ----------------------------------------------------------- on the card --
LENGTHS = (1, 3, 4, 7, 8, 4097, 1_000_003, 2 ** 23 + 5)


def _on_card(device, n, dtype, step, offsets):
    """The CPU leaf of ``n`` on the card, each operand at its offset
    (elements) into a larger buffer."""
    out = []
    for t, off in zip(_leaf(n, dtype, step, seed=n), offsets):
        buf = torch.empty(n + off, dtype=t.dtype, device=device)
        buf[off:] = t.to(device)
        out.append(buf[off:])
    return out


@pytest.mark.card
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_kernel_equals_the_plain_version_bit_for_bit(card, dtype, step,
                                                         donate):
    scal = _scalars(step, 0.37, card)          # the clip active
    # whole buffers (the vector route), and offset views: all four on
    # one 16-byte phase, and each on its own (the scalar route)
    cases = [(n, (0, 0, 0, 0)) for n in LENGTHS] + [
        (n, offs) for n in (4097, 1_000_003)
        for offs in ((4, 8, 4, 12), (1, 0, 0, 0), (0, 3, 0, 0),
                     (0, 0, 2, 1))]
    for n, offs in cases:
        p, g, mu, nu = _on_card(card, n, dtype, step, offs)
        want = adamw_leaf_plain(p.clone(), g, mu.clone(), nu.clone(), *scal,
                                donate=False, **HYPER)
        before = ADAMW.launches
        got = adamw_leaf(p, g, mu, nu, *scal, donate=donate, **HYPER)
        torch.cuda.synchronize()
        assert ADAMW.launches == before + 1
        if donate:
            assert got[0] is p and got[1] is mu and got[2] is nu
        for name, w, t in zip(("p", "mu", "nu"), want, got):
            assert w.dtype == t.dtype and w.shape == t.shape
            assert torch.equal(w.view(torch.int16 if w.dtype == BF16
                                      else torch.int32),
                               t.view(torch.int16 if t.dtype == BF16
                                      else torch.int32)), (name, n, offs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.card
def test_trainer_fit_launches_the_kernel_once_a_leaf_a_step(card):
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cs = _chip_smoke()
    tr = get_training("dlrm-mlperf", reduced=True)
    cfg = dataclasses.replace(tr.config, dtype=F32)
    params = tr.init(cfg, torch.Generator().manual_seed(5), masters=True)
    trainer = Trainer(lambda p, b: tr.loss(cfg, p, b), params,
                      TrainerConfig(opt=tr.opt, log_every=1), device=card)
    n_leaves = len(leaves(trainer.params))
    for steps in (1, 2, 3):
        before = ADAMW.launches
        trainer.fit(lambda c: cs.numpy_train_batch(cfg, tr.batch_size, c),
                    steps)
        assert ADAMW.launches == before + n_leaves
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
