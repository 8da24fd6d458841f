"""The benchmark's frozen counts against hand-worked shapes, and its LM
count held to the port's dry run of granite-3-2b at the REDUCED width."""

import pytest

from bench.lib import counts, hw


def test_flash_counts_by_hand():
    # B 1, H 2, Hkv 1, S 4, D 8, bf16: 10 causal pairs
    assert counts.causal_pairs(4) == 10
    assert counts.flash_forward(1, 2, 1, 4, 8, 2) == (4 * 2 * 8 * 10,
                                                      (64 + 64 + 32 + 32) * 2)
    flops, nbytes = counts.flash_backward(1, 2, 1, 4, 8, 2)
    assert flops == 10 * 2 * 8 * 10
    assert nbytes == 4 * 3 * 4 * 8 * 2 + 4 * 2 * 4


def test_granite_step_flops_by_hand():
    per_layer = 2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048 + 3 * 2048 * 8192
    params = 40 * per_layer + 2048 * 49155
    assert counts.lm_matmul_params(2048, 32, 8, 64, 8192, 40, 49155) == params
    att = 40 * 4 * 8 * 32 * 64 * 4096 * 4097 / 2
    want = 3 * (2 * params * 8 * 4096 + att)
    got = counts.lm_train_flops(2048, 32, 8, 64, 8192, 40, 49155, 8, 4096)
    assert got == want
    assert 5.6e14 < got < 5.65e14


def test_adamw_and_bag_bytes_by_hand():
    assert counts.adamw_bytes(10) == 10 * 4 * 7
    # 5 distinct f32 rows of D 4, 6 ids, a bf16 head, B 3 rows of 3 f32
    # slots
    assert counts.bag_forward_bytes(5, 4, 4, 6, 3, 3, 2, 4) == (
        5 * 16 + 24 + 4 + 3 * 4 * 2 + 3 * 3 * 4 * 4)


def test_dlrm_step_flops_by_hand():
    # 2 dense features, bottom 4-3, D 3, two tables: 3 vectors, 3 pairs;
    # top MLP from 3 + 3 inputs, 2-1
    c = counts.dlrm_train_counts(2, [4, 3], [2, 1], 3, 2, 5)
    assert c == {"bf16": 3.0 * (2 * (2 * 4 + 4 * 3) + 2 * (6 * 2 + 2)) * 5,
                 "f32": 3.0 * 2 * 3 * 3 * 5}
    assert counts.dlrm_forward_flops(2, [4, 3], [2, 1], 3, 2, 5) == {
        k: v / 3 for k, v in c.items()}


def test_bound_takes_the_larger_term():
    assert hw.bound_s({"bf16": 989e12}, 0) == pytest.approx(1.0)
    assert hw.bound_s({"bf16": 989e12, "f32": 67e12}, 0) == pytest.approx(2.0)
    assert hw.bound_s({"bf16": 0.0}, 3.35e12 * 3) == pytest.approx(3.0)


def test_lm_count_against_the_dry_run_at_reduced_width():
    """The dry run traces the port's step: every block matmul 4 x (the
    forward, its recompute, two products in the backward), the
    unembedding 3 x, and each flash call charged its cost.  The
    benchmark's model count, 3 x every matmul's forward without
    recompute, lies between 3/4 of the traced dot FLOPs and all of them;
    the flash charges equal its per-call counts times the calls."""
    from repro_torch.configs.registry import get_bundle
    from repro_torch.launch import dryrun

    b = get_bundle("granite-3-2b", reduced=True)
    c = b.config
    B, S = b.shapes["train_4k"]
    mb = b.microbatches
    dry = dryrun.run(b, "train_4k", (1, 1), ("data", "model"))
    mm = 3 * 2 * counts.lm_matmul_params(
        c.d_model, c.n_heads, c.n_kv_heads, c.d_head, c.d_ff, c.n_layers,
        c.vocab) * B * S
    assert 0.75 * dry["aten_dot_flops"] <= mm <= dry["aten_dot_flops"]
    shape = (B // mb, c.n_heads, c.n_kv_heads, S, c.d_head, 2)
    fwd, bwd = counts.flash_forward(*shape), counts.flash_backward(*shape)
    k = dry["kernels"]
    assert k["flash_attention"]["launches"] == 2 * c.n_layers * mb
    assert k["flash_attention"]["flops"] == 2 * c.n_layers * mb * fwd[0]
    assert k["flash_attention"]["bytes"] == 2 * c.n_layers * mb * fwd[1]
    assert k["flash_attention_backward"]["flops"] == c.n_layers * mb * bwd[0]
    assert k["flash_attention_backward"]["bytes"] == c.n_layers * mb * bwd[1]
    total = counts.lm_train_flops(c.d_model, c.n_heads, c.n_kv_heads,
                                  c.d_head, c.d_ff, c.n_layers, c.vocab, B, S)
    assert total == pytest.approx(mm + 3 * c.n_layers * mb * fwd[0])
