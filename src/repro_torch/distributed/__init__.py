"""Distributed pieces of the port: the sharding rules and their DTensor
placements (``sharding``), the mesh hooks of model code and losses
(``hooks``), and gradient compression (``compression``)."""
