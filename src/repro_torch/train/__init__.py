"""Training of the port (port of ``repro.train``): the train step."""
