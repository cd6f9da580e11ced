"""Fault tolerance: preemption-safe training, heartbeats, straggler notes
(port of ``repro.runtime.fault_tolerance``).

What runs here (single-host container, multi-host by design):

* :class:`PreemptionGuard` — installs SIGTERM/SIGINT handlers that flip a
  flag; the train loop checks it each step and triggers an emergency
  checkpoint + clean exit (maps to TPU preemption notices / maintenance
  events in production).
* :class:`Heartbeat` — a background thread that stamps a file every few
  seconds; an external supervisor (or the launcher's watchdog) restarts the
  job when the stamp goes stale. The stamp includes the process index so a
  coordinator can identify the dead host. The port writes the stamp to a
  temporary file and renames it over the old one, so a reader sees the old
  stamp or the new one, never a truncated file (the reference's writer
  truncates the file before it writes).
* :func:`run_with_restarts` — in-process supervisor used by tests and the
  example trainer: runs a step loop, catches crashes, restores from the last
  committed checkpoint, and resumes. Combined with the step-indexed data
  pipeline this gives *bitwise identical* resume (verified in tests).

Straggler mitigation (design, documented for the 1000+-node target):
SPMD lockstep means a slow chip stalls the psum ring; mitigations wired
into this framework:
  1. the launcher's watchdog marks hosts whose heartbeat lags > T and
     triggers an elastic re-mesh (drop the slice and reshard the last
     checkpoint onto the surviving topology: `runtime/elastic.py` and
     `CheckpointManager.restore_sharded`);
  2. checkpoint cadence bounds lost work to `save_every` steps;
  3. data is step-indexed, so no pipeline state needs recovery, and
     "skip-ahead" after re-mesh is a counter bump.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

__all__ = ["PreemptionGuard", "Heartbeat", "run_with_restarts"]


class PreemptionGuard:
    """Flip-on-signal flag checked by the train loop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self._requested.set()

    @property
    def preempted(self) -> bool:
        return self._requested.is_set()

    def request(self):  # testable without raising signals
        self._requested.set()

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class Heartbeat:
    def __init__(self, path: str, interval: float = 5.0, process_index: int = 0):
        self.path = path
        self.interval = interval
        self.process_index = process_index
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        tmp = f"{self.path}.{os.getpid()}.{id(self)}.tmp"
        while not self._stop.is_set():
            with open(tmp, "w") as f:
                f.write(f"{self.process_index} {time.time()}")
            os.replace(tmp, self.path)
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()

    @staticmethod
    def is_stale(path: str, timeout: float) -> bool:
        try:
            with open(path) as f:
                _, ts = f.read().split()
            return (time.time() - float(ts)) > timeout
        except (OSError, ValueError):
            return True


def run_with_restarts(
    make_state: Callable[[], tuple],
    step_fn: Callable,
    ckpt,
    total_steps: int,
    save_every: int = 10,
    max_restarts: int = 3,
    inject_crash_at: Optional[int] = None,
):
    """In-process restart supervisor (test/example harness).

    ``make_state() -> (state, start_step)`` builds fresh state and restores
    from ``ckpt`` when a committed checkpoint exists. ``step_fn(state, step)
    -> state`` runs one step and may raise. Crashes trigger restore+resume.
    """
    restarts = 0
    crashed_once = False
    while True:
        state, start = make_state()
        try:
            for step in range(start, total_steps):
                if inject_crash_at is not None and step == inject_crash_at and not crashed_once:
                    crashed_once = True
                    raise RuntimeError(f"injected failure at step {step}")
                state = step_fn(state, step)
                if (step + 1) % save_every == 0 or step + 1 == total_steps:
                    ckpt.save(step + 1, state, blocking=True)
            return state, restarts
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
