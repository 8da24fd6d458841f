"""The port's DLRM as a training or serving cell: weights, the
program's loss and trainer settings or its score function, the
reference, and the counts.

The configuration file's keys are the port's ``DLRMConfig`` fields.
Training holds f32 masters; serving holds every weight in the compute
dtype, as the port's serving layout does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from bench.lib import counts
from bench.reference import dlrm as reference

KEYS = ("n_dense", "table_rows", "embed_dim", "bot_mlp", "top_mlp")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Family:
    reference_loss = staticmethod(reference.loss)
    spans = {"adamw": "bench::adamw_update",
             "bag_forward": "bench::bag_forward"}

    def __init__(self, model: dict, mix: dict):
        self.model, self.mix = model, mix
        self.cfg = {k: model[k] for k in KEYS}
        if model["interaction"] != "dot":
            raise ValueError("the port's DLRM has the dot interaction only")
        self.opt = model.get("optimizer")   # training only
        self.reference_cfg = {**self.cfg, "dtype": model["compute_dtype"]}

    def specs(self) -> List[tuple]:
        c = self.cfg
        D, n = c["embed_dim"], len(c["table_rows"])
        out = [(f"tables/t{i}/table", (rows, D), ("normal", 0.02))
               for i, rows in enumerate(c["table_rows"])]
        for prefix, dims in (("bot", [c["n_dense"]] + list(c["bot_mlp"])),
                             ("top", [D + n * (n + 1) // 2]
                              + list(c["top_mlp"]))):
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                out += [(f"{prefix}/fc{i}/w", (a, b), ("normal", a ** -0.5)),
                        (f"{prefix}/fc{i}/b", (b,), ("zeros",))]
        return out

    def program(self):
        from repro_torch.configs.registry import get_training
        from repro_torch.models.recsys import RecsysLoss
        from repro_torch.train.optim import OptConfig
        from repro_torch.train.trainer import TrainerConfig

        tr = get_training(self.model["program"])
        cfg = dataclasses.replace(
            tr.config, dtype=DTYPES[self.model["compute_dtype"]],
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in self.cfg.items()})
        return RecsysLoss(tr.loss, cfg), TrainerConfig(
            opt=OptConfig(**self.opt), log_every=1)

    def serve_program(self):
        """The port's score function and its config."""
        from repro_torch.configs.registry import get_serving

        sv = get_serving(self.model["program"])
        return sv.score, dataclasses.replace(
            sv.config, dtype=DTYPES[self.model["compute_dtype"]],
            **{k: tuple(v) if isinstance(v, list) else v
               for k, v in self.cfg.items()})

    @property
    def serve_dtype(self) -> torch.dtype:
        return DTYPES[self.model["compute_dtype"]]

    reference_logits = staticmethod(reference.logits)

    def patches(self):
        from repro_torch.models import recsys
        from repro_torch.train import trainer
        return [(trainer, "adamw_update", "bench::adamw_update"),
                (recsys, "embedding_bags", "bench::bag_forward")]

    def microbatches(self, batch: Dict[str, torch.Tensor]) -> list:
        return [batch]

    def counts(self, batches=None) -> dict:
        """What one step (training) or call (serving) needs: the MLPs'
        and the interaction's FLOPs, AdamW's bytes, and, from
        ``batches``, the bag's forward bytes and the step's bytes, each a
        mean over the batches.  A step's bytes are AdamW's, the bag
        forward's and the bag backward's (distinct rows written once, the
        cotangent read once); a call's are the bag's.  The bag writes
        f32 rows where the tables are held in the compute dtype (as the
        port's forward does), else the compute dtype."""
        c, B = self.cfg, self.mix["batch"]
        D, n = c["embed_dim"], len(c["table_rows"])
        esize = DTYPES[self.model["compute_dtype"]].itemsize
        serve = self.mix["driver"] == "serve"
        table = esize if serve else 4
        zsize = 4 if table == esize else esize
        args = (c["n_dense"], c["bot_mlp"], c["top_mlp"], D, n, B)
        n_params = sum(math.prod(s[1]) for s in self.specs())
        out = {"flops": (counts.dlrm_forward_flops(*args) if serve
                         else counts.dlrm_train_counts(*args)),
               "n_params": n_params}
        if not serve:
            out["adamw_bytes"] = counts.adamw_bytes(n_params)
        if batches:
            rows = [sum(int(torch.unique(b["sparse"][:, t]).numel())
                        for t in range(n)) for b in batches]
            fwd = [counts.bag_forward_bytes(r, D, table, B * n, B, n + 1,
                                            esize, zsize) for r in rows]
            out["bag_forward_bytes"] = sum(fwd) / len(fwd)
            out["step_bytes"] = out["bag_forward_bytes"]
            if not serve:
                bwd = [r * D * 4 + B * n * D * zsize + 4 * B * n
                       for r in rows]
                out["step_bytes"] += out["adamw_bytes"] + sum(bwd) / len(bwd)
        return out
