"""Checkpoint-driven sweep supervision: restart/resume rounds, a stall
watchdog, and an outage-vs-productive budget split.

A copy of ``pcx/supervisor.py`` (which imports no JAX) for the port's
runner, ``python -m pcx_torch.run_sweep``.  The band sweep
(``pcx_torch.bandstructure.bandgap``) rewrites its JSON library after every
k-point (reference behavior: numerical_experiments.py:482-488), and on
restart recomputes exactly the ``[0,0]`` (pending) and ``[-1,-1]``
(failed) records (numerical_experiments.py:360-404).  That makes process
supervision checkpoint-driven: a crashed, hung or killed worker costs
exactly the in-flight k-point.  The layer guards against three failure
modes:

* a worker can hang with no progress: the stall watchdog kills it once
  neither the checkpoint nor the heartbeat file (touched by the solves,
  ``PCX_HEARTBEAT``) has advanced for its timeout;
* a fresh process's first k-point can take long (start-up, kernel builds):
  the watchdog grants ``stall_grace`` before the first checkpoint write or
  heartbeat of each round, and seeds its progress baseline from the
  pre-existing checkpoint so that a resume does not count its first
  ``stat()`` as progress and collapse the grace to the steady-state
  timeout;
* the device can refuse to start for a long time (outage): attempts that
  change nothing in the checkpoint burn a separate ``outage_budget``
  instead of the productive-round budget.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

__all__ = ["SuperviseConfig", "SweepOutcome", "library_status", "supervise"]


def library_status(path: str, lattice: str, n: int):
    """(pending_indices, failed_indices) of a band-library checkpoint,
    or (None, None) when the file does not exist yet."""
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        lib = json.load(f)
    it = lib.get(f"{lattice}_{n}_iterations", [])
    pending = [i for i, r in enumerate(it) if r[0] == 0]
    failed = [i for i, r in enumerate(it) if r[0] == -1]
    return pending, failed


@dataclass
class SuperviseConfig:
    max_rounds: int = 8          # budget of PRODUCTIVE rounds
    outage_budget: float = 4 * 3600.0   # seconds across no-progress rounds
    stall: float = 900.0         # steady-state no-progress kill timeout
    stall_grace: float = 2400.0  # allowance before a round's first write
    release_sleep: float = 150.0  # device release wait between rounds
    poll: float = 15.0           # watchdog poll period
    # Heartbeat watchdog: the checkpoint-mtime stall timer has per-k-point
    # granularity only.  When ``hb_path`` is set, the worker touches that
    # file while it iterates (pcx_torch.bandstructure._heartbeat reads env
    # PCX_HEARTBEAT: at the solver's doom-check marks and after every
    # solve).  Liveness then becomes: a checkpoint write extends the
    # deadline by ``stall``, a heartbeat by ``hb_stall``, and a worker with
    # NEITHER for ``hb_stall`` after its first beat (or ``stall_grace``
    # before it) is killed and restarted.  That kills a hung worker sooner
    # and keeps one that is legitimately mid-solve on a long point.
    hb_path: str = ""            # "" disables the heartbeat watchdog
    hb_stall: float = 300.0      # kill timeout after heartbeat silence


@dataclass
class SweepOutcome:
    status: str                  # "complete" | "outage-exhausted" | "rounds-exhausted"
    rounds_used: int = 0
    outage_spent: float = 0.0
    stall_kills: int = 0
    pending: list = field(default_factory=list)
    failed: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status == "complete"


def supervise(spawn_worker, path: str, lattice: str, n: int,
              cfg: SuperviseConfig = SuperviseConfig(), *,
              clock=time.time, sleep=time.sleep,
              getmtime=os.path.getmtime, status_fn=library_status,
              log=print) -> SweepOutcome:
    """Run restart/resume rounds of a checkpointed sweep worker.

    ``spawn_worker()`` must return a Popen-like object (``poll``, ``kill``,
    ``wait``, ``returncode``).  ``clock``/``sleep``/``getmtime``/``status_fn``
    are injectable for deterministic tests.
    """
    rnd = 0
    outage_left = cfg.outage_budget
    out = SweepOutcome(status="rounds-exhausted")
    pending = failed = None
    while rnd < cfg.max_rounds:
        t0 = clock()
        state_before = status_fn(path, lattice, n)
        p = spawn_worker()
        # Seed the progress baseline from the PRE-EXISTING checkpoint: a
        # resume's first stat() of the old file must NOT count as progress.
        try:
            last_mtime = getmtime(path)
        except OSError:
            last_mtime = None
        # Same seeding for a stale heartbeat file from a previous round.
        last_hb = None
        if cfg.hb_path:
            try:
                last_hb = getmtime(cfg.hb_path)
            except OSError:
                last_hb = None
        deadline = t0 + cfg.stall_grace
        grace_active = True
        stalled = False
        while p.poll() is None:
            sleep(cfg.poll)
            try:
                mt = getmtime(path)
            except OSError:
                mt = None
            if mt is not None and mt != last_mtime:
                last_mtime = mt
                # A write ends the startup grace (original semantics: SET,
                # not extend); later beats may extend past this via max().
                deadline = clock() + cfg.stall
                grace_active = False
            if cfg.hb_path:
                try:
                    hb = getmtime(cfg.hb_path)
                except OSError:
                    hb = None
                if hb is not None and hb != last_hb:
                    last_hb = hb
                    # The FIRST beat ends the startup grace: from here the
                    # worker proves liveness while it iterates, so the
                    # deadline is CUT to now + hb_stall.  Later beats and
                    # checkpoint writes extend via max().
                    if grace_active:
                        deadline = clock() + cfg.hb_stall
                        grace_active = False
                    else:
                        deadline = max(deadline, clock() + cfg.hb_stall)
            if clock() > deadline:
                log(f"# STALL: no checkpoint progress, "
                    f"{int(clock() - t0)}s into the round — killing worker")
                p.kill()
                p.wait()
                stalled = True
                out.stall_kills += 1
                break
        rc = p.returncode if not stalled else "stall-kill"
        pending, failed = status_fn(path, lattice, n)
        elapsed = clock() - t0
        productive = (pending, failed) != state_before
        log(f"# round {rnd}: rc={rc}, {elapsed:.0f}s, "
            f"pending={len(pending or [])}, failed={len(failed or [])}"
            f"{'' if productive else ' [no-progress: outage?]'}")
        if pending == [] and failed == []:
            log(f"# COMPLETE: {path}")
            out.status = "complete"
            break
        if productive:
            rnd += 1
        else:
            outage_left -= elapsed
            out.outage_spent = cfg.outage_budget - outage_left
            if outage_left <= 0:
                log(f"# OUTAGE BUDGET EXHAUSTED ({cfg.outage_budget}s of "
                    f"no-progress attempts): pending={pending}, "
                    f"failed={failed}")
                out.status = "outage-exhausted"
                break
        # Give the device time to release before the next round attaches.
        sleep(cfg.release_sleep)
    else:
        log(f"# INCOMPLETE after {cfg.max_rounds} rounds: "
            f"pending={pending}, failed={failed}")
    out.rounds_used = rnd
    out.pending = pending or []
    out.failed = failed or []
    return out
