"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant ACE message passing.

Note (DESIGN.md section Arch-applicability): the paper's updatable-index
technique does not apply to the GNN compute path; the cluster arena backs
only the neighbor-list store used by the sampler."""

from repro_torch.configs.families import GNNBundle, gnn_bundle
from repro_torch.models.mace import MACEConfig

CONFIG = MACEConfig(
    name="mace",
    n_layers=2,
    d_hidden=128,
    l_max=2,
    correlation=3,
    n_rbf=8,
    r_cut=2.5,
)

REDUCED = MACEConfig(
    name="mace-smoke",
    n_layers=2, d_hidden=16, l_max=2, correlation=3, n_rbf=4, r_cut=2.5,
)


def bundle(reduced: bool = False) -> GNNBundle:
    if reduced:
        return gnn_bundle("mace", REDUCED, reduced=True)
    return gnn_bundle("mace", CONFIG)
