"""Data of the port (port of ``repro.data``): the deterministic synthetic
token pipeline."""
