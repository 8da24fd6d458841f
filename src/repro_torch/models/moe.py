"""Mixture-of-Experts layer, the port of ``repro.models.moe``: GShard-style
grouped top-k dispatch.

Tokens are processed in groups; each group computes a capacity-bounded
one-hot dispatch tensor, so the layer is einsums (``dispatch="onehot"``,
the configs' default), or sorts the token->expert picks and scatters the
tokens into per-expert buffers (``dispatch="sort"``).  The reference
computes both with jnp einsums, argsort and segment sums outside any
Pallas kernel; so does the port, in plain PyTorch: there is no kernel
here.

Step for step as the reference: the router in f32, top-k by repeated
argmax (the first index wins a tie, in both libraries), the same group
size and capacity, k-major priority in the sort route, the trash row
``E * C`` for dropped picks, and the gates rounded to the compute dtype
before they multiply.  Capacity drops are counted in ``dropped_tokens``;
``experts`` (the picks, (G, T, top_k) in pick order) is the port's own
aux entry, for callers that compare routing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.hooks import BatchAxes, batch_gather, constrain
from repro_torch.distributed.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)
from repro_torch.nn.layers import dense_init

if TYPE_CHECKING:
    from repro_torch.models.transformer import LMPlan


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared_experts: int = 0      # DeepSeek/Moonlight-style always-on experts
    capacity_factor: float = 1.25
    group_tokens: int = 4096       # tokens per dispatch group
    # 'onehot': GShard dispatch/combine einsums; 'sort': argsort-based
    #   scatter/gather dispatch, O(T*k*d) data movement
    dispatch: str = "onehot"


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> Dict:
    """One layer's router (f32 always) and SwiGLU experts (``dtype``),
    in the reference's structure and scales."""
    E, F_ = cfg.n_experts, cfg.d_ff
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(F_)
    p = {
        "router": dense_init(gen, d_model, E, scale=0.02),
        "wg": normal((E, d_model, F_), scale_in),
        "wu": normal((E, d_model, F_), scale_in),
        "wd": normal((E, F_, d_model), scale_out),
    }
    if cfg.n_shared_experts:
        Fs = F_ * cfg.n_shared_experts
        p["shared"] = {
            "wg": normal((d_model, Fs), scale_in),
            "wu": normal((d_model, Fs), scale_in),
            "wd": normal((Fs, d_model), scale_out),
        }
    return p


def _picks(gates: torch.Tensor, top_k: int):
    """Top-k by repeated argmax: per round the expert (G, T), its one-hot
    (G, T, E) f32 and its gate (G, T)."""
    E = gates.shape[-1]
    remaining = gates
    out = []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, E).to(gates.dtype)
        gate_k = (remaining * onehot).sum(-1)
        remaining = remaining * (1.0 - onehot)
        out.append((idx, onehot, gate_k))
    return out


def _top_k_dispatch(
    gates: torch.Tensor,  # (G, T, E) f32 softmax probs
    top_k: int,
    capacity: int,
    plan: Optional[LMPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """GShard dispatch/combine tensors: (G, T, E, C) each.  Where ``plan``
    splits the experts, the columns of this rank's experts alone, (G, T,
    E / size, C), the whole routing's (GSPMD shards them so over
    ``model``), and each pick's gate enters them through
    ``copy_to_model``.  Beside the drops and the picks, the aux values
    hold ``kept`` (G, T), each token's picks that fit their experts'
    capacity, and ``routed`` (G, E), each expert's: the sums of the
    whole dispatch tensor over its slots, exact counts in f32."""
    G, T, E = gates.shape
    own = None if plan is None or not plan.experts else plan.part(E)
    slots = torch.arange(capacity, device=gates.device)
    dispatch = combine = None
    dropped = torch.zeros((), dtype=torch.float32, device=gates.device)
    kept = torch.zeros((G, T), dtype=torch.float32, device=gates.device)
    routed = torch.zeros((G, E), dtype=torch.float32, device=gates.device)
    prev_counts = torch.zeros((G, 1, E), dtype=torch.int32,
                              device=gates.device)
    picks = _picks(gates, top_k)
    for _, onehot, gate_k in picks:
        pos = torch.cumsum(onehot, dim=1) - onehot + prev_counts  # (G, T, E)
        prev_counts = prev_counts + onehot.sum(1, keepdim=True).to(torch.int32)
        pos_k = (pos * onehot).sum(-1)                            # (G, T)
        keep = pos_k < capacity
        dropped = dropped + (1.0 - keep.float()).sum()
        kept = kept + keep.float()
        routed = routed + (onehot * keep[..., None].float()).sum(1)
        # jax.nn.one_hot of ``capacity`` (a dropped pick) is all zeros
        at = torch.where(keep, pos_k.to(torch.int64), capacity)
        cap_oh = (at[..., None] == slots).float()                 # (G, T, C)
        if own is not None:
            onehot = onehot[..., own]
            gate_k = copy_to_model(gate_k, plan.group)
        d_k = onehot[..., None] * cap_oh[..., None, :]            # (G, T, E, C)
        dispatch = d_k if dispatch is None else dispatch + d_k
        c_k = d_k * gate_k[..., None, None]
        combine = c_k if combine is None else combine + c_k
    aux = {"dropped_tokens": dropped,
           "experts": torch.stack([idx for idx, _, _ in picks], -1),
           "kept": kept, "routed": routed}
    return dispatch, combine, aux


def _experts(p: Dict, xe: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU of every expert over its (G, E, C, d) buffer.  The
    reference keeps f32 weights and casts them at each einsum; the port's
    serving weights are held in ``dtype`` already (the cast is then a
    no-op), which computes the same thing and is what fits the card."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dtype))) \
        * torch.einsum("gecd,edf->gecf", xe, p["wu"].to(dtype))
    return torch.einsum("gecf,efd->gecd", h, p["wd"].to(dtype))


def _shared(p: Dict, xg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    sh = p["shared"]
    x = xg.to(dtype)
    hs = F.silu(x @ sh["wg"].to(dtype)) * (x @ sh["wu"].to(dtype))
    return hs @ sh["wd"].to(dtype)


def _sort_slots(gates: torch.Tensor, top_k: int, C: int) -> Dict:
    """The sort route's placement of every pick, (G, k*T) each in sorted
    order: ``t`` the token, ``gate`` its gate, ``keep`` whether it fits
    its expert's capacity, ``slot`` its row ``e * C + rank`` of the (E *
    C + 1)-row buffer (``E * C``, the trash row, where it does not);
    with ``dropped`` and the ``experts`` picks (G, T, k)."""
    G, T, E = gates.shape
    k = top_k
    dev = gates.device
    picks = _picks(gates, k)
    # k-major flattening: within an expert, all round-0 picks outrank
    # round-1 picks (GShard's prev_counts offset), then token order
    e_flat = torch.stack([i for i, _, _ in picks], 1).reshape(G, k * T)
    g_flat = torch.stack([g for _, _, g in picks], 1).reshape(G, k * T)
    t_flat = torch.arange(T, device=dev).repeat(k).expand(G, k * T)

    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sort = torch.gather(e_flat, 1, order)
    # rank within expert = position - index of the expert's first entry
    first = torch.searchsorted(
        e_sort, torch.arange(E, device=dev).expand(G, E).contiguous(),
        right=False)                                              # (G, E)
    pos = torch.arange(T * k, device=dev)[None, :] - torch.gather(first, 1, e_sort)
    keep = pos < C
    return {"t": torch.gather(t_flat, 1, order),
            "gate": torch.gather(g_flat, 1, order),
            "keep": keep,
            "slot": torch.where(keep, e_sort * C + pos, E * C),
            "dropped": (1.0 - keep.float()).sum(),
            "experts": torch.stack([i for i, _, _ in picks], -1)}


def _sorted_dispatch_apply(
    p: Dict, xg: torch.Tensor, gates: torch.Tensor, cfg: MoEConfig,
    C: int, dtype: torch.dtype, plan: Optional[LMPlan] = None,
    xs: Optional[torch.Tensor] = None, kept: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """Sort-based expert dispatch: stable-argsort the token->expert picks,
    scatter tokens into (E, C, d) buffers, gather results back — the
    one-hot route's capacity and priority semantics (first come within an
    expert, round-0 picks before round-1 picks, then token order).

    Where ``plan`` splits the experts, the buffers are this rank's
    experts' (picks of other experts go to the trash row) from ``xs``,
    the tokens as they enter this rank's share, and the output is this
    rank's part of the combine.  With ``kept``, the aux values hold each
    token's picks that fit their experts' capacity, (G, T)."""
    G, T, E = gates.shape
    kT = cfg.top_k * T
    d = xg.shape[-1]
    dev = gates.device
    sl = _sort_slots(gates, cfg.top_k, C)
    slot, keep, t_sort = sl["slot"], sl["keep"], sl["t"]
    gate = sl["gate"]
    El, x_in = E, xg
    if plan is not None and plan.experts:
        El, x_in = E // plan.size, xs
        e0 = plan.rank * El
        keep = keep & (slot >= e0 * C) & (slot < (e0 + El) * C)
        slot = torch.where(keep, slot - e0 * C, El * C)
        gate = copy_to_model(gate, plan.group)

    xt = torch.gather(x_in.to(dtype), 1, t_sort[..., None].expand(G, kT, d))
    # scatter into (G, El*C + 1, d): duplicate writes go to the trash row
    # only, so the kept rows are deterministic
    rows = (torch.arange(G, device=dev)[:, None] * (El * C + 1)
            + slot).reshape(-1)
    xe = torch.zeros((G * (El * C + 1), d), dtype=dtype,
                     device=dev).index_put((rows,), xt.reshape(-1, d))
    xe = xe.reshape(G, El * C + 1, d)[:, : El * C].reshape(G, El, C, d)
    xe = constrain(xe, "batch", "model", None, None)
    ye = constrain(_experts(p, xe, dtype), "batch", "model", None, None)
    # gather back + weighted combine into token order
    ye_flat = ye.reshape(G, El * C, d)
    yt = torch.gather(ye_flat, 1,
                      slot.clamp(max=El * C - 1)[..., None].expand(G, kT, d)) \
        * (keep[..., None] * gate[..., None]).to(dtype)
    seg = (torch.arange(G, device=dev)[:, None] * T + t_sort).reshape(-1)
    y = torch.zeros((G * T, d), dtype=yt.dtype, device=dev).index_add(
        0, seg, yt.reshape(-1, d)).reshape(G, T, d)
    aux = {"dropped_tokens": sl["dropped"], "experts": sl["experts"]}
    if kept:
        aux["kept"] = torch.zeros((G * T,), dtype=torch.float32,
                                  device=dev).index_add(
            0, seg, sl["keep"].reshape(-1).float()).reshape(G, T)
    return y.to(dtype), aux


def _group_size(cfg: MoEConfig, n: int) -> int:
    """The largest group size <= ``group_tokens`` that divides ``n``
    tokens."""
    Tg = min(cfg.group_tokens, n)
    while n % Tg:
        Tg -= 1
    return Tg


def moe_apply(
    p: Dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: MoEConfig,
    dtype: torch.dtype = torch.bfloat16,
    batch: Optional[BatchAxes] = None,
    plan: Optional[LMPlan] = None,
) -> Tuple[torch.Tensor, Dict]:
    """(B, S, d) expert output in ``x.dtype`` and the aux values
    ``dropped_tokens`` and ``balance_loss`` (f32 0-d tensors),
    ``experts`` (the picks), and the balance term's factors
    ``gate_mean`` and ``route_frac`` ((E,) means over the groups), for a
    caller that takes it over more tokens than ``x``'s.

    ``batch`` are the batch axes whose ranks' ``x`` make up the batch (a
    step on a mesh, ``hooks.batch_axes``): the group size is cut from all
    ``batch.size * B * S`` tokens, as the reference cuts it from the
    global batch.  Where a group spans ranks, the tokens of the ranks
    that share groups with this one are gathered
    (``hooks.batch_gather``), their groups are
    routed and computed on each of those ranks, and each keeps its own
    rows; ``gate_mean`` and ``route_frac`` are then those ranks' groups',
    ``experts`` their picks, and ``dropped_tokens`` counts the picks of
    this rank's own tokens, as it does where groups do not span.

    ``plan`` (a step computing on ``model`` shards) names whether ``p``
    holds this rank's experts and its share of the shared experts' hidden
    units; the routing is computed whole on every rank, and the partial
    outputs are summed over ``model``."""
    B, S, d = x.shape
    N = B * S
    Tg = _group_size(cfg, N * (1 if batch is None else batch.size))
    if N % Tg == 0:
        y, aux = _moe_groups(p, x.reshape(N // Tg, Tg, d), cfg, dtype, plan)
        return y.reshape(B, S, d).to(x.dtype), aux
    # groups span ranks: k ranks, each of N tokens, share whole groups
    k = math.lcm(N, Tg) // N
    r = batch.rank
    c0 = r // k * k
    xs = batch_gather(x.reshape(N, d), batch)[c0 * N:(c0 + k) * N]
    y, aux = _moe_groups(p, xs.reshape(k * N // Tg, Tg, d), cfg, dtype,
                         plan, kept=True)
    own = slice((r - c0) * N, (r - c0 + 1) * N)
    kept = aux.pop("kept").reshape(-1)[own]
    aux["dropped_tokens"] = cfg.top_k * N - kept.sum()
    return y.reshape(k * N, d)[own].reshape(B, S, d).to(x.dtype), aux


def _moe_groups(p: Dict, xg: torch.Tensor, cfg: MoEConfig,
                dtype: torch.dtype, plan: Optional[LMPlan],
                kept: bool = False) -> Tuple[torch.Tensor, Dict]:
    """The layer over (G, Tg, d) groups: (G, Tg, d) output in ``dtype``
    and the aux values; with ``kept`` also ``kept`` (G, Tg), each
    token's picks that fit their experts' capacity."""
    G, Tg, d = xg.shape
    E = cfg.n_experts
    C = max(1, int(Tg * cfg.top_k * cfg.capacity_factor / E))

    logits = xg.float() @ p["router"]["w"].float()
    gates = torch.softmax(logits, dim=-1)
    # the tokens as they enter this rank's share of the experts: after
    # the router, whose gradient every rank takes whole
    split = plan is not None and (plan.experts or plan.shared)
    xs = copy_to_model(xg, plan.group) if split else xg

    if cfg.dispatch == "sort":
        y, aux = _sorted_dispatch_apply(p, xg, gates, cfg, C, dtype, plan,
                                        xs, kept)
        me = gates.mean(dim=(0, 1))
        aux["balance_loss"] = E * torch.sum(me * me)  # proxy (no dispatch tensor)
        aux["gate_mean"] = aux["route_frac"] = me
        return _add_shared(p, y, xg, xs, cfg, dtype, plan), aux

    # under a split of the experts, this rank's columns of the dispatch
    dispatch, combine, aux = _top_k_dispatch(gates, cfg.top_k, C, plan)
    kept_picks = aux.pop("kept")
    if kept:
        aux["kept"] = kept_picks

    # load-balancing aux loss (Shazeer): E * sum_e f_e * p_e
    me = gates.mean(dim=(0, 1))
    ce = aux.pop("routed").mean(dim=0) / Tg
    aux["balance_loss"] = E * torch.sum(me * ce)
    aux["gate_mean"], aux["route_frac"] = me, ce

    # expert-parallel placement: groups follow the batch axes, experts the
    # model axis
    xg = constrain(xg, "batch", None, None)
    x_in = xs if plan is not None and plan.experts else xg
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dtype), x_in.to(dtype))
    xe = constrain(xe, "batch", "model", None, None)
    ye = constrain(_experts(p, xe, dtype), "batch", "model", None, None)
    y = torch.einsum("gtec,gecd->gtd", combine.to(dtype), ye)
    return _add_shared(p, y, xg, xs, cfg, dtype, plan), aux


def _add_shared(p: Dict, y: torch.Tensor, xg: torch.Tensor,
                xs: torch.Tensor, cfg: MoEConfig, dtype: torch.dtype,
                plan: Optional[LMPlan]) -> torch.Tensor:
    """The experts' output ``y`` plus the shared experts', with this
    rank's partial parts summed over ``model``: under ``plan`` each of
    the two is partial where it is split and whole where it is not."""
    experts = plan is not None and plan.experts
    shared = plan is not None and plan.shared
    ys = None
    if cfg.n_shared_experts:
        ys = _shared(p, xs if shared else xg, dtype)
    if experts == shared:           # both partial, or both whole
        y = y if ys is None else y + ys
        return reduce_from_model(y, plan.group) if experts else y
    if experts:
        y = reduce_from_model(y, plan.group)
        return y if ys is None else y + ys
    return y + reduce_from_model(ys, plan.group)
