"""Configs of the port (partial copy of ``repro.configs``): the dataclasses
of ``base`` and qwen1.5-0.5b's ``CONFIG``/``SMOKE``."""
