"""Models of the port (port of ``repro.models``): the shared layers, the
MoE and SSM blocks, and the decoder-LM assembly of every family."""
