"""Models of the port (port of ``repro.models``): the dense family's layers
and the decoder-LM assembly."""
