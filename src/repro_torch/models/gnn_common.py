"""GNN host substrate, the port of ``repro.models.gnn_common``: CSR graphs,
the synthetic power-law graph, the GraphSAGE neighbour sampler and the
batched molecule graphs.

The reference's functions are numpy (its module imports ``jax`` for
nothing these use), so the port keeps its own copy: the same seed and
``RandomState`` give bit-identical graphs, samples and batches.  Message
passing itself (gather, edge compute, a segment sum into nodes) lives in
``repro_torch.models.mace``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------ host graphs ---
@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]


def synthetic_graph(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    """Power-law-ish random graph in CSR (host-side, memory-bounded)."""
    rng = np.random.RandomState(seed)
    deg = np.minimum(
        rng.zipf(1.7, size=n_nodes).astype(np.int64) + avg_degree // 2,
        20 * avg_degree,
    )
    deg = (deg * (avg_degree / max(1.0, deg.mean()))).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.concatenate(([0], np.cumsum(deg)))
    indices = rng.randint(0, n_nodes, size=int(indptr[-1]), dtype=np.int64)
    return CSRGraph(indptr=indptr, indices=indices)


class NeighborSampler:
    """Layered fanout sampling (GraphSAGE style) with fixed padded shapes.

    Returns a subgraph dict:
      nodes     (n_max,)   global node ids (padded with 0)
      node_mask (n_max,)   1 for real nodes
      edges_src (e_max,)   LOCAL indices into nodes
      edges_dst (e_max,)
      edge_mask (e_max,)
      n_seeds              the seeds are local nodes 0..n_seeds-1
    """

    def __init__(self, graph: CSRGraph, fanout: Sequence[int]):
        self.g = graph
        self.fanout = list(fanout)

    @staticmethod
    def padded_sizes(n_seeds: int, fanout: Sequence[int]) -> Tuple[int, int]:
        n_max, e_max, frontier = n_seeds, 0, n_seeds
        for f in fanout:
            e = frontier * f
            e_max += e
            n_max += e
            frontier = e
        return n_max, e_max

    def sample(self, seeds: np.ndarray, rng: np.random.RandomState) -> Dict:
        n_max, e_max = self.padded_sizes(len(seeds), self.fanout)
        nodes: List[int] = list(seeds)
        local = {int(n): i for i, n in enumerate(seeds)}
        src_l: List[int] = []
        dst_l: List[int] = []
        frontier = list(seeds)
        for f in self.fanout:
            nxt: List[int] = []
            for u in frontier:
                lo, hi = self.g.indptr[u], self.g.indptr[u + 1]
                if hi <= lo:
                    continue
                picks = self.g.indices[
                    rng.randint(lo, hi, size=min(f, hi - lo))
                ]
                for vv in picks:
                    v = int(vv)
                    if v not in local:
                        local[v] = len(nodes)
                        nodes.append(v)
                    # message flows v -> u
                    src_l.append(local[v])
                    dst_l.append(local[u])
                    nxt.append(v)
            frontier = nxt
        n, e = len(nodes), len(src_l)
        out = {
            "nodes": np.zeros(n_max, np.int64),
            "node_mask": np.zeros(n_max, np.float32),
            "edges_src": np.zeros(e_max, np.int32),
            "edges_dst": np.zeros(e_max, np.int32),
            "edge_mask": np.zeros(e_max, np.float32),
            "n_seeds": len(seeds),
        }
        out["nodes"][:n] = nodes
        out["node_mask"][:n] = 1.0
        out["edges_src"][:e] = src_l
        out["edges_dst"][:e] = dst_l
        out["edge_mask"][:e] = 1.0
        return out


def batch_small_graphs(
    n_graphs: int, n_nodes: int, n_edges: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Batched molecule-style graphs: block-diagonal edge list + graph ids."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n_nodes, size=(n_graphs, n_edges))
    dst = rng.randint(0, n_nodes, size=(n_graphs, n_edges))
    offs = (np.arange(n_graphs) * n_nodes)[:, None]
    return {
        "edges_src": (src + offs).reshape(-1).astype(np.int32),
        "edges_dst": (dst + offs).reshape(-1).astype(np.int32),
        "graph_of": np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32),
    }
