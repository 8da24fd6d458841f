"""The port's dense LM family as a training cell: weights, the
program's loss and trainer settings, the reference, and the counts.

The configuration file uses the keys of the model's published
``config.json``; :data:`KEYS` maps them to the port's
``TransformerConfig``.  The port's LM has no embedding, attention,
residual or logit multipliers: a file that states any other than the
plain ones (1, 1/sqrt(head size), 1, 1) cannot be run as stated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from bench.lib import counts
from bench.reference import lm as reference

KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
        "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
        "head_dim": "d_head", "intermediate_size": "d_ff",
        "vocab_size": "vocab", "rope_theta": "rope_theta",
        "rms_norm_eps": "rms_eps", "tie_word_embeddings": "tie_embeddings",
        "attention_bias": "qkv_bias"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Family:
    reference_loss = staticmethod(reference.loss)
    # the spans each per-layer metric reads: a label and the profiler op
    # whose launches it covers (the bench's own ranges start "bench::")
    spans = {"adamw": "bench::adamw_update",
             "attention_fwd": "_FlashAttention",
             "attention_bwd": "_FlashAttentionBackward"}

    def __init__(self, model: dict, mix: dict):
        self.model, self.mix = model, mix
        self.cfg = {v: model[k] for k, v in KEYS.items()}
        want = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                "logits_scaling": 1.0,
                "attention_multiplier": self.cfg["d_head"] ** -0.5}
        for key, value in want.items():
            if not math.isclose(model[key], value, rel_tol=1e-6):
                raise ValueError(f"{key} {model[key]}: the port's LM runs "
                                 f"{value} only")
        if not (model["hidden_act"] == "silu" and not model["mlp_bias"]
                and not model["attention_bias"]
                and model["tie_word_embeddings"]):
            raise ValueError("the LM cell runs tied, bias-free SwiGLU models")
        self.opt = model["optimizer"]
        self.reference_cfg = {**self.cfg, "dtype": model["torch_dtype"]}

    # ---------------------------------------------------------- weights --
    def specs(self) -> List[tuple]:
        c = self.cfg
        L, d, ff = c["n_layers"], c["d_model"], c["d_ff"]
        qd, kvd = c["n_heads"] * c["d_head"], c["n_kv_heads"] * c["d_head"]

        def dense(d_in, d_out):
            return (L, d_in, d_out), ("normal", d_in ** -0.5)

        return [("embed/table", (c["vocab"], d), ("normal", 0.02)),
                ("ln_f", (d,), ("ones",)),
                ("block/ln1", (L, d), ("ones",)),
                ("block/ln2", (L, d), ("ones",)),
                ("block/wq/w", *dense(d, qd)),
                ("block/wk/w", *dense(d, kvd)),
                ("block/wv/w", *dense(d, kvd)),
                ("block/wo/w", *dense(qd, d)),
                ("block/mlp/wg/w", *dense(d, ff)),
                ("block/mlp/wu/w", *dense(d, ff)),
                ("block/mlp/wd/w", *dense(ff, d))]

    # ---------------------------------------------------------- program --
    def program(self):
        """The port's loss and trainer settings for this configuration."""
        from repro_torch.configs.registry import get_bundle
        from repro_torch.models.transformer import LMLoss
        from repro_torch.train.optim import OptConfig
        from repro_torch.train.trainer import TrainerConfig

        base = get_bundle(self.model["program"]).config
        cfg = dataclasses.replace(
            base, name=self.model["name"],
            dtype=DTYPES[self.model["torch_dtype"]], **self.cfg)
        return LMLoss(cfg), TrainerConfig(
            opt=OptConfig(**self.opt), microbatches=self.mix["microbatches"],
            log_every=1)

    def patches(self):
        """(module, attribute, range label) the benchmark wraps in a
        profiler range while it traces."""
        from repro_torch.train import trainer
        return [(trainer, "adamw_update", "bench::adamw_update")]

    # -------------------------------------------------------- reference --
    def microbatches(self, batch: Dict[str, torch.Tensor]) -> list:
        mb = self.mix["microbatches"]
        return [{k: v.chunk(mb)[i] for k, v in batch.items()}
                for i in range(mb)]

    # ----------------------------------------------------------- counts --
    def counts(self, batches=None) -> dict:
        """What one step needs: model FLOPs (bf16 GEMMs and attention),
        AdamW's bytes, and each flash call's FLOPs and bytes."""
        c, mix = self.cfg, self.mix
        B, S = mix["batch"], mix["seq"]
        esize = DTYPES[self.model["torch_dtype"]].itemsize
        shape = (B // mix["microbatches"], c["n_heads"], c["n_kv_heads"], S,
                 c["d_head"], esize)
        n = sum(math.prod(s[1]) for s in self.specs())
        return {"flops": {"bf16": counts.lm_train_flops(
                    c["d_model"], c["n_heads"], c["n_kv_heads"], c["d_head"],
                    c["d_ff"], c["n_layers"], c["vocab"], B, S)},
                "n_params": n,
                "adamw_bytes": counts.adamw_bytes(n),
                "attention_fwd": counts.flash_forward(*shape),
                "attention_bwd": counts.flash_backward(*shape)}
