"""Functional layers of the LM serving path (the port of ``repro.nn``)."""
