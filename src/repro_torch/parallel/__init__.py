"""The sharding rules of the port (port of ``repro.parallel``)."""
