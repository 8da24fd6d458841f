"""MACE, the port of ``repro.models.mace``: higher-order equivariant
message passing (arXiv:2206.07697) on the segment-sum substrate.

The structure is the reference's (l_max 2, correlation order 3,
E(3)-equivariant):

  * node states h: (N, k, 9), k channels x the real-SH irreps
    [l0|l1(3)|l2(5)];
  * radial basis: n_rbf Bessel functions with a smooth cutoff;
  * A-basis: A_t = sum over edges s->t of R_l(r_e) * C(h_s, Y(r̂_e)),
    through the real Gaunt tensor C[a,b,c] (``gaunt_tensor``);
  * B-basis: B2 = C(A, A), B3 = C(B2, A), with per-l channel mixing;
  * readout: the invariant (l=0) channels -> MLP -> node logits or
    energies.

The reference computes it with jnp gathers, ``jax.ops.segment_sum`` and
einsums outside any Pallas kernel; the port is plain PyTorch (gathers,
``index_add_`` into zeros, matrix products).  How it is laid out:

  * Each three-operand einsum of the reference is written out in one
    order, so the same products run whether or not opt_einsum is
    installed: an edge's message is ``bmm(h_s, Y·C)`` with Y·C formed
    first, (e, 9, 9); ``gaunt_product`` takes B2 and B3 as an (n·k, 9) x
    (9, 81) product and then a batched (1, 9) x (9, 9) one.
  * ``jax.checkpoint(layer)`` and the per-edge-chunk checkpoint under
    ``lax.scan`` become one ``autograd.Function`` a layer (``_Layer``):
    the forward keeps only the layer's input (the scalars before the
    first layer, the (N, k, 9) states after) and the backward recomputes
    the layer.  Edges are taken chunk by chunk as in the reference (more
    than ``edge_chunk`` edges: padded to whole chunks with (0, 0) edges
    whose Y and rbf are zero, so the sum is over the same terms), each
    chunk in blocks of at most ``EDGE_BLOCK`` edges, and the per-node
    algebra in blocks of ``NODE_BLOCK`` nodes.  The backward writes each
    block's gradient into one buffer per tensor: ``torch.utils.checkpoint``
    around a chunk that gathers from h would make a zero-filled (N, k, 9)
    gradient for every chunk.
  * The last layer keeps only its invariant channels, (N, k): the
    readout reads nothing else.
  * ``constrain(...)``, the reference's activation-sharding hook, sits
    where the reference's does (Y, rbf, R, the gathered h, the messages,
    A and each layer's output); it is a no-op outside a mesh, and on one
    it leaves the port's local tensors as they are.
  * On a mesh (the batch's inputs DTensors placed over the batch axes)
    each rank computes on its own blocks, as the reference's
    ``constrain`` pins lay the work out
    (:mod:`repro_torch.distributed.graph_parallel`): the first layer's
    scalars and every layer's node algebra and output on its own node
    rows, Y, rbf and the messages on its own edge block (whose indices
    name the whole graph's nodes).  A layer gathers the node states
    whole, sums its edges' messages into a whole partial A, and sums the
    partials into the rows' owners; the positions are gathered whole,
    with no gradient.  The readout and the loss take the rank's own
    rows, and a molecule's energy sums its nodes' outputs over the ranks
    that hold them.

Gradients reach the parameters and the node inputs, not the positions:
the reference's losses take none with respect to them, and a call that
asks for one raises.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.distributed.graph_parallel import (
    GraphShards,
    graph_shards,
    local_inputs,
    sum_over_nodes,
)
from repro_torch.distributed.hooks import batch_mean, constrain, rows_like
from repro_torch.nn.layers import dense_init, mlp_apply, mlp_init
from repro_torch.tree import flatten_with_path, leaves, unflatten

Params = Dict[str, Any]

N_IRREPS = 9  # l=0 (1) + l=1 (3) + l=2 (5)
L_OF = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])  # irrep -> l
# working-set bounds of one block: an edge block holds at most four
# (EDGE_BLOCK, k, 9) f32 tensors, 2.4 GB each at k 128; a node block's B
# products (NODE_BLOCK * k, 81) f32 ones, 1.36 GB at k 128
EDGE_BLOCK = 1 << 19
NODE_BLOCK = 1 << 15


def real_sph_harm(u: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics l<=2 for unit vectors u: (..., 3) -> (..., 9)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    c2a = 1.0925484305920792
    c2b = 0.31539156525252005
    c2c = 0.5462742152960396
    return torch.stack(
        [
            torch.full_like(x, c0),
            c1 * y,
            c1 * z,
            c1 * x,
            c2a * x * y,
            c2a * y * z,
            c2b * (3 * z * z - 1.0),
            c2a * x * z,
            c2c * (x * x - y * y),
        ],
        dim=-1,
    )


def _np_real_sph_harm(u: np.ndarray) -> np.ndarray:
    """Pure-numpy twin of real_sph_harm (for the Gaunt quadrature)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    c2a = 1.0925484305920792
    c2b = 0.31539156525252005
    c2c = 0.5462742152960396
    return np.stack(
        [np.full_like(x, c0), c1 * y, c1 * z, c1 * x, c2a * x * y,
         c2a * y * z, c2b * (3 * z * z - 1.0), c2a * x * z,
         c2c * (x * x - y * y)],
        axis=-1,
    )


@lru_cache(maxsize=1)
def gaunt_tensor() -> np.ndarray:
    """C[a,b,c] = ∫ Y_a Y_b Y_c dΩ by Gauss-Legendre x uniform-phi quadrature
    (exact for the l<=6 band limit of triple products of l<=2)."""
    nct, nph = 64, 128
    ct, wt = np.polynomial.legendre.leggauss(nct)
    ph = (np.arange(nph) + 0.5) * (2 * np.pi / nph)
    ctg, phg = np.meshgrid(ct, ph, indexing="ij")
    st = np.sqrt(1.0 - ctg**2)
    xyz = np.stack([st * np.cos(phg), st * np.sin(phg), ctg], axis=-1)
    Y = _np_real_sph_harm(xyz)                       # (nct, nph, 9)
    w = wt[:, None] * (2 * np.pi / nph)              # (nct, 1)
    C = np.einsum("tpa,tpb,tpc,tp->abc", Y, Y, Y, np.broadcast_to(w, ctg.shape))
    C[np.abs(C) < 1e-12] = 0.0
    return C.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128          # channels k
    l_max: int = 2               # fixed at 2 in this implementation
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 2.5
    d_feat: int = 0              # input node feature dim (0: species embed)
    n_species: int = 32
    n_out: int = 1               # 1: energy regression; >1: node classes
    readout_mlp: Tuple[int, ...] = (64,)
    dtype: torch.dtype = torch.float32   # equivariant algebra is f32
    # edge-chunked message passing: graphs beyond this many edges are
    # taken in chunks of this size (padded edges are zero-length self
    # loops -> masked)
    edge_chunk: int = 1 << 21


def mace_init(cfg: MACEConfig, gen: torch.Generator) -> Params:
    """f32 parameters on ``gen``'s device, in the reference's structure
    and scales (``layers`` is a list)."""
    k = cfg.d_hidden
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    p: Params = {}
    if cfg.d_feat:
        p["feat_in"] = dense_init(gen, cfg.d_feat, k)
    else:
        p["species"] = {"table": normal((cfg.n_species, k), 0.5)}
    p["layers"] = [
        {
            # radial MLP: rbf -> per-channel, per-l weights
            "radial": mlp_init(gen, (cfg.n_rbf, 32, k * 3)),
            # channel mixers for B1, B2, B3 per l block: (k, k, 3)
            "w1": normal((k, k, 3), 1 / math.sqrt(k)),
            "w2": normal((k, k, 3), 1 / math.sqrt(k)),
            "w3": normal((k, k, 3), 1 / math.sqrt(k)),
            "self": normal((k, k, 3), 1 / math.sqrt(k)),
        }
        for _ in range(cfg.n_layers)
    ]
    p["readout"] = mlp_init(gen, (k,) + cfg.readout_mlp + (cfg.n_out,))
    return p


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff (MACE eq. 5).

    Near the cutoff the envelope is a difference of terms of size 15, so
    its f32 value there is rounding noise, and that noise decides on
    which side of the radial MLP's relu kink an edge falls (its bias
    starts at 0), which moves the first bias's gradient.  So it is
    rounded as the reference rounds it, on the card as on the CPU: the
    powers of t are products in the order of XLA's ``integer_pow`` (t·t²,
    t²·t², t·t⁴), and r is divided by a tensor, not a Python number,
    which the card would turn into a product with its reciprocal."""
    rc = torch.full((), r_cut, dtype=torch.float32, device=r.device)
    rs = torch.clamp(r, min=1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rs / rc) / rs
    t = torch.clamp(r / rc, 0.0, 1.0)[..., None]
    t2 = t * t
    t4 = t2 * t2
    env = 1.0 - 10.0 * (t * t2) + 15.0 * t4 - 6.0 * (t * t4)
    return basis * env


def _per_irrep(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) per l -> (..., 9) per irrep, ``x[..., L_OF]``, for
    weights only: gathered along the last axis of an (E, k, 3) activation
    it took a third of an ogbn-products step on the card."""
    return x.index_select(-1, torch.as_tensor(L_OF, device=x.device))


def _mix(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-l channel mixing: w (k,k,3), h (N,k,9) -> (N,k,9)."""
    return torch.einsum("nka,jka->nja", h, _per_irrep(w))


def gaunt_product(x: torch.Tensor, y: torch.Tensor,
                  C: torch.Tensor) -> torch.Tensor:
    """``einsum("...a,...b,abc->...c", x, y, C)`` in a fixed order: x·C
    as one (M, 9) x (9, 81) product laid out [m, c, b], then each row's
    (9, 9) block times y and summed over b, the innermost axis (a batched
    product would be M one-row products, which cuBLAS splits into many
    launches).  The reference's ``B2 = C(A, A)`` is
    ``gaunt_product(A, A, C)``, ``B3 = C(B2, A)`` is
    ``gaunt_product(B2, A, C)``."""
    Cc = C.permute(0, 2, 1).reshape(N_IRREPS, N_IRREPS * N_IRREPS)
    xc = (x.reshape(-1, N_IRREPS) @ Cc).view(-1, N_IRREPS, N_IRREPS)
    out = (xc * y.reshape(-1, 1, N_IRREPS)).sum(-1)
    return out.view(x.shape)


def y_gaunt(Y: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """YC[e, a, c] = sum_b Y[e, b] C[a, b, c], (E, 9, 9): the edge
    message's first contraction."""
    Cb = C.permute(1, 0, 2).reshape(N_IRREPS, N_IRREPS * N_IRREPS)
    return (Y @ Cb).view(-1, N_IRREPS, N_IRREPS)


def _tensor_product(hs: torch.Tensor, YC: torch.Tensor) -> torch.Tensor:
    """tp[e, k, c] = sum_a hs[e, k, a] YC[e, a, c]; ``hs`` (e, k) means
    scalar states (irrep 0 only)."""
    if hs.dim() == 2:
        return hs[:, :, None] * YC[:, None, 0, :]
    return torch.bmm(hs, YC)


def _radial(radial: Params, rbf: torch.Tensor, k: int) -> torch.Tensor:
    """The radial MLP's weight of each channel and irrep, (e, k, 9): the
    reference's (e, k, 3) per-l weights, each l's repeated over its
    irreps.  The repeat is taken on the last layer's columns, (32, 3k) ->
    (32, 9k), so the product writes R per irrep at once and its gradient
    folds back onto the weights, never onto an (e, k, 3) activation."""
    last = f"fc{len(radial) - 1}"
    w, b = radial[last]["w"], radial[last]["b"]
    per_irrep = {last: {"w": _per_irrep(w.view(-1, k, 3)).reshape(
                            w.shape[0], k * N_IRREPS),
                        "b": _per_irrep(b.view(k, 3)).reshape(k * N_IRREPS)}}
    R = mlp_apply({**radial, **per_irrep}, rbf, dtype=torch.float32)
    return constrain(R, "batch", None).view(-1, k, N_IRREPS)


def edge_message(lp: Params, hs: torch.Tensor, Y: torch.Tensor,
                 rbf: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """phi_e[k, c] = R[k, c] * sum_{a,b} C[a,b,c] h_s[k,a] Y[b] for a
    block of edges: ``einsum("eka,eb,abc->ekc", hs, Y, C) * R``, Y·C
    first.  ``hs`` (e, k, 9), or (e, k) for the first layer, whose
    states are scalars (irrep 0) only."""
    tp = _tensor_product(hs, y_gaunt(Y, C))
    return tp * _radial(lp["radial"], rbf, hs.shape[1])


def node_update(lp: Params, h: torch.Tensor, A: torch.Tensor,
                C: torch.Tensor, last: bool = False) -> torch.Tensor:
    """The layer's per-node algebra for a block of nodes: the
    correlation-3 products of A, the four channel mixes and their sum,
    as the reference orders it.  ``h`` (n, k) means scalar states; with
    ``last`` only the invariant channels come back, (n, k)."""
    if h.dim() == 2:
        h = F.pad(h[:, :, None], (0, N_IRREPS - 1))
    B2 = gaunt_product(A, A, C)
    B3 = gaunt_product(B2, A, C)
    m = _mix(lp["w1"], A) + _mix(lp["w2"], B2) + _mix(lp["w3"], B3)
    out = constrain(_mix(lp["self"], h) + m, "batch", None, None)
    return out[:, :, 0] if last else out


def _blocks(n: int, size: int) -> Iterator[Tuple[int, int]]:
    for i in range(0, n, size):
        yield i, min(i + size, n)


def _edge_blocks(n_edges: int, chunk: int) -> Iterator[Tuple[int, int]]:
    """Blocks of at most EDGE_BLOCK edges, chunk by chunk, none across a
    chunk's end."""
    for c0, c1 in _blocks(n_edges, chunk):
        for b0, b1 in _blocks(c1 - c0, EDGE_BLOCK):
            yield c0 + b0, c0 + b1


@dataclasses.dataclass
class _Edges:
    """One forward's per-edge constants, padded to whole chunks."""
    Y: torch.Tensor      # (E', 9)
    rbf: torch.Tensor    # (E', n_rbf)
    src: torch.Tensor    # (E',)
    dst: torch.Tensor    # (E',)
    chunk: int           # edges a chunk (E' when unchunked)
    C: torch.Tensor      # (9, 9, 9)


def _aggregate(lp: Params, h: torch.Tensor, e: _Edges) -> torch.Tensor:
    """A = segment_sum over edges of their messages, into (N, k, 9); no
    autograd (the forward, and its recompute in the backward)."""
    A = torch.zeros((h.shape[0], h.shape[1], N_IRREPS), dtype=torch.float32,
                    device=h.device)
    for b0, b1 in _edge_blocks(e.src.shape[0], e.chunk):
        hs = constrain(h.index_select(0, e.src[b0:b1]), "batch", None, None)
        msg = edge_message(lp, hs, e.Y[b0:b1], e.rbf[b0:b1], e.C)
        A.index_add_(0, e.dst[b0:b1], constrain(msg, "batch", None, None))
    return constrain(A, "batch", None, None)


def _node_sums(lp: Params, h: torch.Tensor, e: _Edges,
               shards: Optional[GraphShards]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole graph's states and A of the rows of ``h``: without
    ``shards`` h itself and every edge's message summed into its node;
    with them the states gathered whole, this rank's edge block's
    messages summed into a whole partial, and the partials summed into
    their owners' rows."""
    hw = h if shards is None else shards.gather(h)
    A = _aggregate(lp, hw, e)
    return hw, (A if shards is None else shards.to_owners(A))


class _Layer(torch.autograd.Function):
    """One interaction layer, ``h -> node_update(h, A(h))``, remat as the
    reference's ``jax.checkpoint(layer)``: the forward keeps its input h
    and the parameters; the backward recomputes A and takes the
    gradient a block at a time into one buffer per tensor: each node
    block's by autograd, each edge block's written out (only the radial
    MLP's by autograd), so a block never holds more than a few
    (EDGE_BLOCK, k, 9) tensors.  With ``shards`` h and the output are
    this rank's node rows and the edges its edge block; the backward
    transposes the route's collectives (``graph_parallel``) outside the
    block loops."""

    @staticmethod
    def forward(ctx, edges: _Edges, shards: Optional[GraphShards],
                template: Params, last: bool, h: torch.Tensor,
                *params: torch.Tensor) -> torch.Tensor:
        lp = unflatten(template, list(params))
        A = _node_sums(lp, h, edges, shards)[1]
        N, k = h.shape[:2]
        out = torch.empty((N, k) if last else (N, k, N_IRREPS),
                          dtype=torch.float32, device=h.device)
        for n0, n1 in _blocks(N, NODE_BLOCK):
            out[n0:n1] = node_update(lp, h[n0:n1], A[n0:n1], edges.C, last)
        ctx.edges, ctx.shards = edges, shards
        ctx.template, ctx.last = template, last
        ctx.save_for_backward(h, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out: torch.Tensor):
        h, *params = ctx.saved_tensors
        e, shards = ctx.edges, ctx.shards
        template, last = ctx.template, ctx.last
        k = h.shape[1]
        radial = [i for i, (path, _) in enumerate(flatten_with_path(template))
                  if path[0] == "radial"]
        node = [i for i in range(len(params)) if i not in radial]
        g_p = [torch.zeros_like(p) for p in params]

        def live(idx):
            """Detached leaves at ``idx`` that take a gradient."""
            return [params[i].detach().requires_grad_() for i in idx]

        def add(idx, grads):
            for i, g in zip(idx, grads):
                if g is not None:
                    g_p[i] += g

        # the whole graph's states' gradient takes this rank's node rows'
        # from the node blocks and its edge block's from the edge blocks
        hw, A = _node_sums(unflatten(template, params), h, e, shards)
        first = 0 if shards is None else shards.nodes.first
        g_h = torch.zeros_like(hw)
        g_A = torch.empty_like(A)
        for n0, n1 in _blocks(h.shape[0], NODE_BLOCK):
            with torch.enable_grad():
                hc = h[n0:n1].detach().requires_grad_()
                Ac = A[n0:n1].detach().requires_grad_()
                ps = live(node)
                lp = list(params)
                for i, p in zip(node, ps):
                    lp[i] = p
                out = node_update(unflatten(template, lp), hc, Ac, e.C, last)
                gh, gA, *gp = torch.autograd.grad(
                    out, [hc, Ac, *ps], g_out[n0:n1], allow_unused=True)
            g_h[first + n0:first + n1], g_A[n0:n1] = gh, gA
            add(node, gp)
        del A
        if shards is not None:
            g_A = shards.to_owners_t(g_A)
        radial_template = template["radial"]
        for b0, b1 in _edge_blocks(e.src.shape[0], e.chunk):
            src, YC = e.src[b0:b1], y_gaunt(e.Y[b0:b1], e.C)
            with torch.enable_grad():
                ps = live(radial)
                R = _radial(unflatten(radial_template, ps), e.rbf[b0:b1], k)
            # msg = tp * R: d tp = d msg * R, d hs = d tp @ YC^T
            g_msg = g_A.index_select(0, e.dst[b0:b1])
            g_tp = g_msg * R.detach()
            if hw.dim() == 2:
                g_hs = (g_tp * YC[:, None, 0, :]).sum(-1)
            else:
                g_hs = torch.bmm(g_tp, YC.transpose(1, 2))
            del g_tp
            g_h.index_add_(0, src, g_hs)
            del g_hs
            # d R = d msg * tp
            g_msg.mul_(_tensor_product(hw.index_select(0, src), YC))
            add(radial, torch.autograd.grad(R, ps, g_msg))
            del g_msg
        if shards is not None:
            g_h = shards.gather_t(g_h)
        return (None, None, None, None, g_h, *g_p)


def _padded_edges(cfg: MACEConfig, Y, rbf, src, dst, C) -> _Edges:
    """The edge arrays as the reference's scan takes them: beyond
    ``edge_chunk`` edges, padded to whole chunks with (0, 0) edges whose
    Y and rbf are zero."""
    E = src.shape[0]
    n_chunks = max(1, -(-E // cfg.edge_chunk)) if cfg.edge_chunk else 1
    if n_chunks == 1:
        return _Edges(Y, rbf, src, dst, max(E, 1), C)
    pad = n_chunks * cfg.edge_chunk - E

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return _Edges(padded(Y), padded(rbf), padded(src), padded(dst),
                  cfg.edge_chunk, C)


def mace_forward(
    cfg: MACEConfig,
    p: Params,
    node_feat: torch.Tensor,   # (N, d_feat) f32 or (N,) int species
    positions: torch.Tensor,   # (N, 3)
    edges_src: torch.Tensor,   # (E,) int32 or int64
    edges_dst: torch.Tensor,   # (E,)
    edge_mask: Optional[torch.Tensor] = None,  # (E,)
    shards: Optional[GraphShards] = None,
) -> torch.Tensor:
    """Returns node outputs (N, n_out).  With ``shards``
    (``graph_parallel.graph_shards`` of the batch) the node inputs and
    the outputs are this rank's node rows, and the edge inputs its edge
    block, whose indices name the whole graph's nodes."""
    if positions.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "mace_forward takes no gradient with respect to positions "
            "(the reference's losses need none)")
    dev = positions.device
    C = torch.as_tensor(gaunt_tensor(), device=dev)
    if cfg.d_feat:
        scal = node_feat.float() @ p["feat_in"]["w"]
    else:
        scal = p["species"]["table"].index_select(0, node_feat.reshape(-1))

    src, dst = edges_src, edges_dst
    if shards is not None:
        positions = shards.gather(positions)
    rvec = positions.index_select(0, dst) - positions.index_select(0, src)
    x, y, z = rvec.unbind(-1)
    # |rvec|^2 summed in the reference's order, and its square root
    # correctly rounded (taken in f64; torch's f32 sqrt on the CPU is off
    # by an ulp in about 0.7% of values, XLA's and CUDA's are exact): r
    # then has the same bits on the card, the CPU and the reference, and
    # so has the cutoff envelope, whose rounding noise near r_cut decides
    # on which side of the radial MLP's relu kink an edge falls
    r = torch.sqrt(((x * x + y * y) + z * z + 1e-18).double()).float()
    u = rvec / torch.clamp(r, min=1e-6)[:, None]
    Y = real_sph_harm(u)                                     # (E, 9)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.r_cut)                # (E, n_rbf)
    # zero-length (self-loop / padded) edges carry no message: Y(0) is a
    # fixed non-scalar vector and would break equivariance if summed in
    rbf = rbf * (r > 1e-6)[:, None]
    if edge_mask is not None:
        rbf = rbf * edge_mask[:, None]
    Y = constrain(Y, "batch", None)
    rbf = constrain(rbf, "batch", None)
    del rvec, x, y, z, r, u
    edges = _padded_edges(cfg, Y, rbf, src, dst, C)
    del Y, rbf

    # the first layer's input is the scalars alone, (N, k): its (N, k, 9)
    # states are zero outside irrep 0 and are never formed whole
    h = scal
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        h = _Layer.apply(edges, shards, lp, i == n - 1, h, *leaves(lp))
    inv = h if n else scal                                   # (N, k)
    return mlp_apply(p["readout"], inv, dtype=torch.float32)


# ------------------------------------------------------------- objectives ---
def mace_node_xent(cfg: MACEConfig, p: Params, batch: Dict) -> torch.Tensor:
    shards = graph_shards(batch)
    b = local_inputs(batch, shards)
    out = mace_forward(
        cfg, p, b["feat"], b["pos"], b["edges_src"],
        b["edges_dst"], b.get("edge_mask"), shards,
    )
    logits = out.float()
    labels, mask = b["labels"], b.get("label_mask")
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(min=0)[:, None])[:, 0]
    nll = logz - gold
    if mask is not None:
        return batch_mean(torch.sum(nll * mask), torch.sum(mask))
    return batch_mean(torch.sum(nll), nll.shape[0])


def mace_energy_mse(cfg: MACEConfig, p: Params, batch: Dict) -> torch.Tensor:
    """The molecules' energies from every node's output: this rank's
    nodes' outputs added by ``graph_of`` into a partial of every graph,
    summed over the node axes (a graph's nodes may lie on several
    ranks), and the rows of ``energy`` as it is placed."""
    shards = graph_shards(batch)
    b = local_inputs(batch, shards)
    out = mace_forward(
        cfg, p, b["species"], b["pos"], b["edges_src"],
        b["edges_dst"], b.get("edge_mask"), shards,
    )[:, 0]
    n_graphs = batch["energy"].shape[0]
    energies = torch.zeros(n_graphs, dtype=out.dtype, device=out.device)
    energies = energies.index_add(0, b["graph_of"], out)
    energies = rows_like(sum_over_nodes(energies, shards), batch["energy"])
    sq = (energies - b["energy"]) ** 2
    return batch_mean(torch.sum(sq), sq.shape[0])
