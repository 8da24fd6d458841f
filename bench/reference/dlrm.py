"""A plain PyTorch DLRM: the loss whose gradients the benchmark's DLRM
training cells are held to.

No kernels of the port.  Bottom MLP with ReLU after every layer, one row
of each table a sample, the dot interaction of the 27 vectors (bottom
output first, then the tables in order) keeping each pair i < j once in
row-major order, the bottom output and those pairs into the top MLP
(ReLU between its layers, none after the last), and the mean binary
cross-entropy of its logit (arXiv:1906.00091).

Precision: f32 master weights and tables, cast to the configuration's
dtype ``dt`` where they are used; the MLPs' products, bias sums and
activations in ``dt``; each looked-up row rounded to ``dt``; the
interaction's products in f32 from those rows, its pairs rounded to
``dt``; the cross-entropy in f32.  With ``dt`` float32 the whole model
is f32 (TF32 off).
"""

from __future__ import annotations

from typing import Dict

import torch

from bench.reference.precision import DTYPES, linear, rounded


def mlp(p: Dict[str, torch.Tensor], prefix: str, n: int, x: torch.Tensor,
        final_relu: bool, mm: str) -> torch.Tensor:
    dt = x.dtype
    for i in range(n):
        x = linear(x, p[f"{prefix}/fc{i}/w"], dt, mm) \
            + p[f"{prefix}/fc{i}/b"].to(dt)
        if i < n - 1 or final_relu:
            x = torch.relu(x)
    return x


def logits(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
           cfg: dict, mm: str = "none") -> torch.Tensor:
    """(B,) f32 logits; ``mm`` rounds the MLPs' operands and the rows
    looked up further (a control)."""
    dt = DTYPES[cfg["dtype"]]
    n_tables = len(cfg["table_rows"])
    d = mlp(p, "bot", len(cfg["bot_mlp"]), batch["dense"].to(dt), True, mm)
    ids = batch["sparse"].long()
    z = torch.stack([d] + [rounded(p[f"tables/t{i}/table"][ids[:, i]].to(dt),
                                   mm) for i in range(n_tables)], 1).float()
    inter = z @ z.transpose(1, 2)
    iu = torch.triu_indices(n_tables + 1, n_tables + 1, 1, device=z.device)
    x = torch.cat([d, inter[:, iu[0], iu[1]].to(dt)], -1)
    return mlp(p, "top", len(cfg["top_mlp"]), x, False, mm)[:, 0].float()


def loss(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
         cfg: dict, mm: str = "none") -> torch.Tensor:
    logit = logits(p, batch, cfg, mm)
    y = batch["label"]
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))
