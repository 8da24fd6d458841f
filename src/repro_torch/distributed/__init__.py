"""Distributed helpers of the port; for now the gradient compression that
the trainer applies (``compression``)."""
