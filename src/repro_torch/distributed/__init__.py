"""Distributed pieces of the port: the sharding rules and their DTensor
placements (``sharding``), the mesh hooks of model code and losses
(``hooks``), the LM's split over the ``model`` axis and its collectives
(``tensor_parallel``), and gradient compression (``compression``)."""
