"""Preemption watchdog: a resumable exit when a termination signal
arrives while the main thread is blocked inside a native call (port of
`simpb_tpu/utils/watchdog.py`, plain Python).

CPython runs signal handlers only between bytecodes on the main thread.
A step loop blocked in a native wait (a stalled CUDA synchronisation or
runtime call, a collective that never completes) never reaches the
Python handler, so the SIGTERM preemption checkpoint of
`tools/train.py` is unreachable in precisely the failure it exists for.
This module closes that hole:

  * ``signal.set_wakeup_fd`` makes the C-level handler write each
    incoming signal number to a pipe (async-signal-safe, independent of
    the bytecode loop), so a watcher sees the signal even while the main
    thread is stuck in native code;
  * a daemon thread blocks on that pipe; on a watched signal it gives
    the main loop ``deadline_s`` seconds to make progress: a
    ``heartbeat()`` (called at every step boundary) or an
    ``acknowledge()`` (called when the normal Python-handler preemption
    path engages);
  * if the main thread shows no progress before the deadline, the
    watchdog writes a ``WATCHDOG_EXIT.json`` marker naming the last
    completed checkpoint as the recovery point and force-exits the
    process with ``EXIT_CODE_WATCHDOG`` (75, ``EX_TEMPFAIL``). The
    orchestrator resumes with ``--resume-from`` as after a normal
    preemption exit; the periodic checkpoints bound the lost work.

Fault injection for tests: ``data/native_preprocess.py::native_hang``
(an EINTR-restarting native sleep) and the ``SIMPB_TEST_NATIVE_HANG``
hook of ``tools/train.py``.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Optional, Sequence

# EX_TEMPFAIL: "try again" — the run is resumable from the recorded
# checkpoint; distinct from both success (0) and a crash
EXIT_CODE_WATCHDOG = 75

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


class PreemptionWatchdog:
    """Arm from the MAIN thread; call ``heartbeat()`` at every step
    boundary and ``record_checkpoint(path)`` after each completed save.
    """

    def __init__(
        self,
        deadline_s: float = 120.0,
        work_dir: Optional[str] = None,
        signals: Sequence[int] = _DEFAULT_SIGNALS,
        poll_s: float = 0.25,
    ):
        self.deadline_s = float(deadline_s)
        self.work_dir = work_dir
        self.signals = tuple(int(s) for s in signals)
        self.poll_s = float(poll_s)
        self._beats = 0
        self._acked = False
        self._armed = False
        self._last_ckpt: Optional[str] = None
        self._last_step: Optional[int] = None
        self._rfd: Optional[int] = None
        self._wfd: Optional[int] = None
        self._old_wakeup_fd: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    # -- main-thread API ------------------------------------------------
    def arm(self) -> "PreemptionWatchdog":
        """Install the wakeup pipe + start the watcher (main thread
        only — ``signal.set_wakeup_fd`` requires it). Idempotent."""
        if self._armed or self.deadline_s <= 0:
            return self
        # the wakeup fd only fires for signals with a Python-level
        # handler; watched signals still at their default disposition
        # would terminate the process before the watchdog could act —
        # give them a no-op handler (callers like tools/train.py have
        # already installed their own, which is left untouched)
        for s in self.signals:
            try:
                if signal.getsignal(s) in (signal.SIG_DFL, None):
                    signal.signal(s, lambda *_: None)
            except (ValueError, OSError):
                pass
        self._rfd, self._wfd = os.pipe()
        os.set_blocking(self._wfd, False)
        # warn_on_full_buffer=False: a flooded pipe only drops repeat
        # notifications; one byte is enough to trip the watcher
        self._old_wakeup_fd = signal.set_wakeup_fd(
            self._wfd, warn_on_full_buffer=False
        )
        self._thread = threading.Thread(
            target=self._watch, name="preemption-watchdog", daemon=True
        )
        self._thread.start()
        self._armed = True
        return self

    def disarm(self) -> None:
        """Restore the previous wakeup fd and stop escalating (the
        watcher thread parks on a closed pipe read and exits)."""
        if not self._armed:
            return
        self._armed = False
        self._acked = True
        try:
            signal.set_wakeup_fd(
                self._old_wakeup_fd if self._old_wakeup_fd is not None
                else -1
            )
        except ValueError:
            pass  # not on the main thread; fd stays — harmless
        for fd in (self._wfd, self._rfd):
            try:
                os.close(fd)
            except OSError:
                pass

    def heartbeat(self, step: Optional[int] = None) -> None:
        """Main-loop progress marker (call once per step boundary)."""
        self._beats += 1
        if step is not None:
            self._last_step = step

    def acknowledge(self) -> None:
        """The normal Python-handler preemption path engaged (the loop
        observed the signal and is checkpointing): stand down
        permanently — the graceful exit owns shutdown from here."""
        self._acked = True

    def record_checkpoint(self, path: str) -> None:
        """Name the recovery point the forced exit should advertise."""
        self._last_ckpt = path

    # -- watcher thread -------------------------------------------------
    def _watch(self) -> None:
        watched = set(self.signals)
        while True:
            try:
                data = os.read(self._rfd, 64)
            except OSError:
                return  # disarmed
            if not data:
                return
            sigs = set(data) & watched
            if not sigs or self._acked:
                continue
            self._escalate(sorted(sigs)[0])

    def _escalate(self, signum: int) -> None:
        t0 = time.monotonic()
        beats0 = self._beats
        while time.monotonic() - t0 < self.deadline_s:
            time.sleep(self.poll_s)
            if self._acked or not self._armed:
                return  # graceful path engaged / disarmed
            if self._beats != beats0:
                # the main thread is alive and stepping: it will reach
                # the Python handler's should_stop checkpoint at the
                # next boundary — keep watching from the new baseline
                beats0 = self._beats
                t0 = time.monotonic()
        self._force_exit(signum)

    def _force_exit(self, signum: int) -> None:
        record = {
            "reason": "termination signal with no main-thread progress "
                      "(blocked in a native wait)",
            "signal": signum,
            "deadline_s": self.deadline_s,
            "last_completed_checkpoint": self._last_ckpt,
            "last_completed_step": self._last_step,
            "exit_code": EXIT_CODE_WATCHDOG,
        }
        msg = (
            f"[watchdog] signal {signum} received {self.deadline_s:.0f}s "
            "ago with no main-thread progress (native wait); forcing "
            f"resumable exit {EXIT_CODE_WATCHDOG}. Recovery point: "
            f"{self._last_ckpt or '<no checkpoint completed yet>'}\n"
        )
        try:
            os.write(2, msg.encode())
        except OSError:
            pass
        if self.work_dir:
            try:
                os.makedirs(self.work_dir, exist_ok=True)
                with open(
                    os.path.join(self.work_dir, "WATCHDOG_EXIT.json"), "w"
                ) as f:
                    json.dump(record, f, indent=1)
                    f.write("\n")
            except OSError:
                pass
        os._exit(EXIT_CODE_WATCHDOG)
