"""Batched serving engine over the paged KV substrate (the port of
``repro.serve.engine``).

Continuous batching: requests join a fixed-slot batch as slots free up;
each engine step decodes one token for every active slot.  The
:class:`~repro_torch.core.paged_kv.PagedKVManager` tracks page placement
with the paper's CH/S/SR semantics, as bookkeeping only, exactly as in
the reference: its tables publish full pages and keep the tail in the SR
buffer, so they miss tokens attention must read.  The device cache is the
per-slot head-major cache of :func:`~repro_torch.models.transformer.make_cache`,
whose fixed slot block table drives the paged-attention kernel.

Admission, slot reuse, stop rules and the manager's calls are the
reference's, so ``stats()`` equals it key for key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.paged_kv import PagedKVManager
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    make_cache,
    prefill,
)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # (S,) token ids
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        batch_slots: int = 4,
        s_max: int = 256,
        page_size: int = 16,
        chain_limit: int = 9,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = batch_slots
        self.s_max = s_max
        self.cache = make_cache(cfg, batch_slots, s_max, page_size=page_size,
                                device=self.device)
        self.kv_mgr = PagedKVManager(
            n_pages=batch_slots * (s_max // page_size) * 2,
            page_size=page_size,
            chain_limit=chain_limit,
        )
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.steps = 0

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _select(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy choice: the argmax of each row of ``logits``, on the host."""
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64),
                                     device=self.device)
            logits, cache1 = prefill(self.cfg, self.params, prompt[None, :])
            S = req.prompt.shape[0]
            self.cache["k"][:, slot, :, :S] = cache1["k"][:, 0]
            self.cache["v"][:, slot, :, :S] = cache1["v"][:, 0]
            self.cache["len"][slot] = S
            first = int(self._select(logits)[0])
            req.out_tokens.append(first)
            self.slot_req[slot] = req
            self.kv_mgr.new_sequence(req.req_id)
            self.kv_mgr.append_tokens(req.req_id, S)

    # --------------------------------------------------------------- step --
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.slots,), np.int64)
        for i in active:
            tokens[i] = self.slot_req[i].out_tokens[-1]
        logits, self.cache = decode_step(
            self.cfg, self.params, torch.as_tensor(tokens, device=self.device),
            self.cache,
        )
        nxt = self._select(logits)
        lens = self.cache["len"].cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            req.out_tokens.append(int(nxt[i]))
            self.kv_mgr.append_tokens(req.req_id, 1)
            hit_limit = len(req.out_tokens) >= req.max_new_tokens
            full = int(lens[i]) + 1 >= self.s_max
            if hit_limit or full:
                req.done = True
                self.kv_mgr.free_sequence(req.req_id)
                self.slot_req[i] = None
                self.cache["len"][i] = 0
        self.steps += 1
        return len(active)

    def run_until_done(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        while (self.queue or any(self.slot_req)) and self.steps < max_steps:
            before = [r for r in self.slot_req]
            self.step()
            for r in before:
                if r is not None and r.done:
                    done.append(r)
        return done

    def stats(self) -> Dict:
        return {
            "steps": self.steps,
            "kv": dataclasses.asdict(self.kv_mgr.stats),
            "fragmentation": self.kv_mgr.fragmentation(),
        }
