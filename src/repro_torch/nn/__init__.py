"""Functional layers of the LM and recsys serving paths (the port of
``repro.nn``)."""
