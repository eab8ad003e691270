"""Fault injection for the durability layer (the port's copy of
``repro/wal/faults.py``).

Two harnesses live here:

* **Crash points** (DESIGN.md §9) — a :class:`FaultInjector` armed with one
  :class:`CrashPoint` and an occurrence count kills a *single-process*
  serving loop at an exact protocol point (the crash-matrix tests).
* **Chaos schedule** (DESIGN.md §12) — a :class:`FaultSchedule` is a seeded
  timeline of :class:`ChaosEvent`\\ s (crash, fsync stall, latency spike,
  torn segment, bit-flip corruption) fired *by sim time* against named
  components (the single-engine frontend's own WAL is ``"wal"``).
  Components register a handler; the serving loop polls
  :meth:`FaultSchedule.fire_due` at commit boundaries, so a whole run under
  chaos stays a pure function of (trace, config, schedule seed).

A :class:`FaultInjector` is armed with one :class:`CrashPoint` and an
occurrence count; durability-aware code calls :meth:`FaultInjector.reach`
at every protocol point, and the injector raises :class:`SimulatedCrash`
when its armed point is reached for the N-th time.  The exception
propagates out of the serving loop exactly like a process kill would end
it: whatever the WAL/checkpoint directory holds at that instant is what
recovery gets.

The one place a raised exception is *weaker* than a kill — bytes written
but not yet fsynced may transparently survive in the page cache — is
handled by the ``on_crash`` hook: the WAL passes a callback that tears the
unsynced tail (truncates the segment mid-record) before the crash fires,
simulating the adversarial outcome a real power loss can produce.  The
recovery invariant under test is therefore the strict one: *acked implies
durable* (fsync returned) and *unacked implies absent after recovery*.

Crash points (the full matrix ``tests/test_durability.py`` kills at):

================================  =============================================
point                             state at the kill
================================  =============================================
``BEFORE_WAL_APPEND``             commit formed, nothing logged — ops unacked,
                                  legitimately lost
``AFTER_WAL_APPEND``              record written, **not fsynced** — tail torn;
                                  recovery must truncate it, never resurrect
``AFTER_WAL_FSYNC``               record durable ⇒ ops **acked**, but not yet
                                  applied to the engine — replay must apply
``AFTER_APPLY``                   acked + applied, before maintenance
``MID_CASCADE``                   between emptying-cascade work units inside
                                  ``maintain`` — index mid-restructure
``MID_CHECKPOINT``                snapshot leaves written, manifest not yet —
                                  the half-checkpoint must be ignored
``BEFORE_CHECKPOINT_RENAME``      manifest fsynced, step dir still ``.tmp`` —
                                  recovery rolls the provable step forward
``AFTER_CHECKPOINT``              checkpoint complete, WAL tail not yet
                                  truncated — replay must skip ≤-snapshot LSNs
================================  =============================================
"""
from __future__ import annotations

import dataclasses
import enum
import os

import numpy as np


class CrashPoint(enum.Enum):
    BEFORE_WAL_APPEND = "before-wal-append"
    AFTER_WAL_APPEND = "after-wal-append"          # written, not fsynced
    AFTER_WAL_FSYNC = "after-wal-fsync"            # durable == acked
    AFTER_APPLY = "after-apply"
    MID_CASCADE = "mid-cascade"
    MID_CHECKPOINT = "mid-checkpoint"              # leaves written, no manifest
    BEFORE_CHECKPOINT_RENAME = "before-checkpoint-rename"
    AFTER_CHECKPOINT = "after-checkpoint"          # before WAL truncation


class SimulatedCrash(RuntimeError):
    """The injected kill: propagates out of the serving loop like SIGKILL."""

    def __init__(self, point: CrashPoint, occurrence: int):
        super().__init__(f"simulated crash at {point.value} "
                         f"(occurrence {occurrence})")
        self.point = point
        self.occurrence = occurrence


class FaultInjector:
    """Raise :class:`SimulatedCrash` the ``at_occurrence``-th time
    ``point`` is reached.

    One injector arms one point; ``fired`` records whether the crash
    actually happened (a test that armed a point the run never reaches can
    tell the difference between "survived" and "never exercised").
    """

    def __init__(self, point: CrashPoint, at_occurrence: int = 1):
        assert at_occurrence >= 1
        self.point = point
        self.at_occurrence = int(at_occurrence)
        self.seen = 0
        self.fired = False

    def reach(self, point: CrashPoint, on_crash=None) -> None:
        """Announce that ``point`` was reached.

        ``on_crash`` (optional callable) runs just before the crash is
        raised — the hook the WAL uses to tear its unsynced tail.
        """
        if point is not self.point:
            return
        self.seen += 1
        if self.seen == self.at_occurrence:
            self.fired = True
            if on_crash is not None:
                on_crash()
            raise SimulatedCrash(point, self.seen)


def reach(injector: FaultInjector | None, point: CrashPoint,
          on_crash=None) -> None:
    """``injector.reach`` that tolerates ``injector=None`` (production)."""
    if injector is not None:
        injector.reach(point, on_crash)


# ============================================================ chaos schedule
class ChaosKind(enum.Enum):
    """Event vocabulary of the seeded chaos harness (DESIGN.md §12)."""

    CRASH = "crash"                  # component dies (node loss, WAL gone)
    FSYNC_STALL = "fsync_stall"      # next fsyncs pay +seconds (arg)
    LATENCY_SPIKE = "latency_spike"  # service multiplied by arg for a window
    TORN_SEGMENT = "torn_segment"    # WAL tail physically torn mid-record
    BIT_FLIP = "bit_flip"            # one byte flipped in the newest segment


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: fire ``kind`` at sim time ``t`` on ``target``.

    ``target`` names a registered component (e.g. ``"g0/n1"`` for group 0's
    node 1, ``"wal"`` for the single-engine frontend's log); ``arg`` is the
    kind-specific magnitude: stall seconds for ``FSYNC_STALL``, the service
    multiplier for ``LATENCY_SPIKE`` (its window is ``dur_s``), unused
    otherwise.
    """

    t: float
    kind: ChaosKind
    target: str
    arg: float = 0.0
    dur_s: float = 0.0

    def describe(self) -> dict:
        return {"t": self.t, "kind": self.kind.value, "target": self.target,
                "arg": self.arg, "dur_s": self.dur_s}


class FaultSchedule:
    """Seeded, time-ordered chaos timeline with a component registry.

    Components register a handler (``schedule.register(name, fn)``); the
    serving loop calls :meth:`fire_due` at every commit boundary and each
    due event is dispatched to its target's handler exactly once, in time
    order.  Events whose target was never registered are counted
    (``unrouted``) rather than lost silently — a misspelled ``--chaos``
    target should be visible in the report, not a silent no-op.

    Construction: :meth:`parse` for the driver's ``--chaos`` spec DSL,
    :meth:`random` for seeded soak schedules, or pass events directly.
    """

    def __init__(self, events=()):
        self.events = sorted(events, key=lambda e: (e.t, e.target,
                                                    e.kind.value))
        self._next = 0
        self._handlers: dict = {}
        self.fired: list[ChaosEvent] = []
        self.unrouted: list[ChaosEvent] = []

    # ------------------------------------------------------------- building
    @staticmethod
    def parse(spec: str) -> "FaultSchedule":
        """Parse the driver's ``--chaos`` DSL.

        Spec = ``;``-separated events, each ``kind@t[:target[:arg[:dur]]]``
        (target defaults to ``"wal"``, the single-engine frontend's log)::

            crash@0.5:g0/n0
            fsync_stall@1.0:g1/n1:0.02
            latency_spike@2.0:g0:8:0.5
            torn_segment@1.5:g2/n1;bit_flip@1.7:g2/n2

        plus one optional ``random:<n>@<seed>[:t_lo,t_hi]`` element that
        appends a seeded random schedule over the registered targets at
        fire time is **not** supported here — use :meth:`random` (the soak
        tests) for generated schedules; the DSL stays explicit.
        """
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            head, _, rest = part.partition("@")
            kind = ChaosKind(head.strip())
            fields = rest.split(":")
            if not fields or not fields[0]:
                raise ValueError(f"chaos event {part!r} needs a time: "
                                 "kind@t[:target[:arg[:dur]]]")
            t = float(fields[0])
            target = fields[1] if len(fields) > 1 and fields[1] else "wal"
            arg = float(fields[2]) if len(fields) > 2 else 0.0
            dur = float(fields[3]) if len(fields) > 3 else 0.0
            events.append(ChaosEvent(t, kind, target, arg, dur))
        return FaultSchedule(events)

    @staticmethod
    def random(n: int, *, seed: int, t_lo: float, t_hi: float,
               targets, kinds=tuple(ChaosKind),
               stall_s: float = 0.01, spike: float = 8.0,
               spike_dur_s: float = 0.05,
               min_gap_s: float = 0.0) -> "FaultSchedule":
        """Seeded random schedule over ``targets`` (soak harness).

        ``min_gap_s`` spaces *destructive* events (CRASH / TORN_SEGMENT /
        BIT_FLIP) on the same **group** — the prefix of the target name up
        to ``/`` — so a group always gets time to detect, promote, and
        rebuild before it is hit again; without the gap a random schedule
        can destroy every copy of an acked write at once, which no
        replication factor survives (the soak test's invariant would then
        be unsatisfiable, not violated).
        """
        rng = np.random.default_rng(seed)
        targets = list(targets)
        destructive = {ChaosKind.CRASH, ChaosKind.TORN_SEGMENT,
                       ChaosKind.BIT_FLIP}
        last_hit: dict = {}
        events = []
        times = np.sort(rng.uniform(t_lo, t_hi, size=n))
        for t in times:
            kind = kinds[int(rng.integers(len(kinds)))]
            target = targets[int(rng.integers(len(targets)))]
            group = target.split("/")[0]
            if kind in destructive:
                if t - last_hit.get(group, -np.inf) < min_gap_s:
                    kind = ChaosKind.FSYNC_STALL   # demote to a benign fault
                else:
                    last_hit[group] = float(t)
            arg = {ChaosKind.FSYNC_STALL: stall_s,
                   ChaosKind.LATENCY_SPIKE: spike}.get(kind, 0.0)
            dur = spike_dur_s if kind is ChaosKind.LATENCY_SPIKE else 0.0
            events.append(ChaosEvent(float(t), kind, target, arg, dur))
        return FaultSchedule(events)

    # ------------------------------------------------------------ dispatch
    def register(self, target: str, handler) -> None:
        """Route events for ``target`` to ``handler(event)``.  Re-register
        freely (a respawned node reuses its group's target names)."""
        self._handlers[target] = handler

    def unregister(self, target: str) -> None:
        self._handlers.pop(target, None)

    def fire_due(self, now: float) -> list[ChaosEvent]:
        """Dispatch every event with ``t <= now`` not yet fired, in order.

        Returns the events dispatched this call (routed or not), so the
        caller can trace them.
        """
        out = []
        while self._next < len(self.events) and \
                self.events[self._next].t <= now:
            ev = self.events[self._next]
            self._next += 1
            handler = self._handlers.get(ev.target)
            if handler is None:
                self.unrouted.append(ev)
            else:
                handler(ev)
                self.fired.append(ev)
            out.append(ev)
        return out

    @property
    def pending(self) -> int:
        return len(self.events) - self._next

    @property
    def next_time(self) -> float | None:
        """Fire time of the earliest undispatched event (clock-jump hint
        for sim serving loops), or None when the schedule is drained."""
        return self.events[self._next].t if self._next < len(self.events) \
            else None

    def describe(self) -> dict:
        """JSON-ready summary for reports."""
        return {
            "n_events": len(self.events),
            "fired": [e.describe() for e in self.fired],
            "unrouted": [e.describe() for e in self.unrouted],
            "pending": self.pending,
        }


def tear_wal_tail(wal_dir: str, *, frac: float = 0.5) -> int:
    """Physically tear the newest WAL segment mid-record (TORN_SEGMENT).

    Truncates the last ``1 - frac`` of the newest non-empty segment file —
    an adversarial partial write.  Returns bytes removed (0 when there is
    nothing to tear).  The next :class:`~.log.WriteAheadLog` open
    (or re-scan) sees a torn record and truncates back to the last valid
    prefix.
    """
    segs = sorted(n for n in os.listdir(wal_dir)
                  if n.startswith("wal_") and n.endswith(".log"))
    for name in reversed(segs):
        path = os.path.join(wal_dir, name)
        size = os.path.getsize(path)
        if size == 0:
            continue
        keep = max(1, int(size * frac))
        with open(path, "r+b") as f:
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())
        return size - keep
    return 0


def flip_wal_byte(wal_dir: str, *, offset_frac: float = 0.5) -> int:
    """Flip one byte in the newest non-empty WAL segment (BIT_FLIP).

    The per-record CRC turns the flip into an invalid record on the next
    scan, truncating the segment from that record on — silent bit-rot
    becomes a detectable (and bounded) tail loss.  Returns the absolute
    byte offset flipped, or -1 when there was nothing to corrupt.
    """
    segs = sorted(n for n in os.listdir(wal_dir)
                  if n.startswith("wal_") and n.endswith(".log"))
    for name in reversed(segs):
        path = os.path.join(wal_dir, name)
        size = os.path.getsize(path)
        if size == 0:
            continue
        off = min(size - 1, max(0, int(size * offset_frac)))
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
            f.flush()
            os.fsync(f.fileno())
        return off
    return -1
