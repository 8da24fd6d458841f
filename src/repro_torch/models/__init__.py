"""Models of the port: the decoder-only transformer, dense or MoE
(``transformer``, ``moe``) over the attention kernels (``attention``),
the recsys archs (``recsys``), and MACE (``mace``) with its host graph
substrate (``gnn_common``)."""
