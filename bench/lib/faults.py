"""Faults planted under the timed path, for the checks that ``correct``
catches them: each a context manager that breaks the port as a later
change could, by the driver of the cells it applies to.

Training (``Trainer.fit``):

  * ``state_unchanged``: the optimizer leaves the parameters and its
    moments as they were (its step count still advances);
  * ``half_batch``: every gradient is taken over the first half of each
    microbatch's rows, the loss the mean over those.

Serving (DLRM's score function):

  * ``half_batch``: only the first half of each batch is scored, the
    rest of the answers left at 0;
  * ``answer_altered``: one score of every call is moved by 1.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, attr: str, make):
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


def state_unchanged():
    from repro_torch.train import trainer

    def make(orig):
        def frozen(cfg, grads, state, params, donate=False, grad_norm=None):
            return params, {**state, "step": state["step"] + 1}, {
                "grad_norm": grad_norm}
        return frozen
    return _patched(trainer, "adamw_update", make)


def half_batch_trained():
    from repro_torch.train import trainer

    def make(orig):
        def half(loss_fn, params, batch):
            return orig(loss_fn, params, {k: v[: v.shape[0] // 2]
                                          for k, v in batch.items()})
        return half
    return _patched(trainer, "value_and_grad", make)


def half_batch_served():
    import torch

    from repro_torch.models import recsys

    def make(orig):
        def half(cfg, p, batch, plan=None):
            n = batch["dense"].shape[0]
            s = orig(cfg, p, {k: v[: n // 2] for k, v in batch.items()},
                     plan)
            return torch.cat([s, torch.zeros(n - n // 2, dtype=s.dtype,
                                             device=s.device)])
        return half
    return _patched(recsys, "dlrm_forward", make)


def answer_altered():
    from repro_torch.models import recsys

    def make(orig):
        def altered(cfg, p, batch, plan=None):
            s = orig(cfg, p, batch, plan)
            s[0] += 1
            return s
        return altered
    return _patched(recsys, "dlrm_forward", make)


FAULTS = {"train": {"state_unchanged": state_unchanged,
                    "half_batch": half_batch_trained},
          "serve": {"half_batch": half_batch_served,
                    "answer_altered": answer_altered}}
