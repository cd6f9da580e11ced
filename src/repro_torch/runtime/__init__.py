"""Runtime of the port (port of ``repro.runtime``): preemption, heartbeats
and the in-process restart supervisor."""
