"""Models of the port: the dense decoder-only transformer's serving entry
points (``transformer``) over the attention kernels (``attention``), and
the recsys archs' serving entry points (``recsys``)."""
