"""Configs of the port (copy of ``repro.configs``): the dataclasses of
``base``, the ten architectures' ``CONFIG``/``SMOKE`` and the registry."""
