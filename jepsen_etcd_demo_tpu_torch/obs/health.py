"""Backend health supervisor: healthy -> degraded -> wedged, and back.

The JAX package's obs/health.py with a probe of the card in place of its
trivial-jit probe. The checking daemon (serve/) reads this state
machine: a wedged backend takes no new work (there is no host failover:
a degraded one is still launched on).

State machine (one supervisor per process, :func:`get_supervisor`):

  healthy --[consecutive failures >= fail_degraded]--> degraded
  degraded --[consecutive failures >= fail_wedged]--> wedged
  * --[probe TIMEOUT]--> wedged          (a hang is the wedged signature)
  * --[any success]--> healthy           (recovery is immediate)

Signals come from two directions:

  * **passive**: the hot paths report outcomes they already have. A
    bucket read back by sched/engine.py, a chunk launched by the stream
    consumer, a finished check phase of runner/core.py are successes
    (:meth:`~BackendSupervisor.note_ok`); a launch or read-back that
    raises is a failure (:meth:`~BackendSupervisor.note_failure`).
  * **active**: :meth:`~BackendSupervisor.maybe_probe` runs
    :func:`probe_backend` (a small check through csrc/wgl3_sweep.cu in a
    subprocess) once `probe_interval_s` has passed. Only the checking
    daemon's dispatch thread calls it (idle or parked), so no other
    process, and no timed check, pays the subprocess; the JAX package
    probes from its hot paths instead. A fresh supervisor starts its
    interval clock at construction.

A transition sets the `health.state` gauge (0 healthy / 1 degraded /
2 wedged) of the active capture (obs.capture) and carries provenance
(when, why, which caller), which `/healthz` shows as it is.

Environment knobs (the JAX package's names):
  JEPSEN_TPU_HEALTH_PROBE_TIMEOUT_S   subprocess probe timeout (240)
  JEPSEN_TPU_HEALTH_PROBE_INTERVAL_S  active-probe rate limit (300)
  JEPSEN_TPU_HEALTH_FAIL_DEGRADED     consecutive failures -> degraded (1)
  JEPSEN_TPU_HEALTH_FAIL_WEDGED       consecutive failures -> wedged (3)
  JEPSEN_TPU_HEALTH_PROBE=0           no active probing (the passive
                                      signals still drive the machine)
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

HEALTHY = "healthy"
DEGRADED = "degraded"
WEDGED = "wedged"
# State -> numeric level: the health.state gauge and the /metrics
# jepsen_tpu_health_state series share this one mapping.
STATE_LEVEL = {HEALTHY: 0, DEGRADED: 1, WEDGED: 2}

PROBE_TIMEOUT_S = 240.0
PROBE_INTERVAL_S = 300.0
# The marker phrase of a probe timeout's reason: a caller that has only
# the reason string classifies a hang by it.
TIMEOUT_MARKER = "CUDA device hung or lost?"

# The probe: import the port, resolve the device and check a 20-op
# history through the dense sweep there (on a card, csrc/wgl3_sweep.cu).
_PROBE_CODE = """
import random, sys, torch
from jepsen_etcd_demo_tpu_torch.checkers.linearizable import Linearizable
from jepsen_etcd_demo_tpu_torch.ops import wgl3_kernels as wk
from jepsen_etcd_demo_tpu_torch.utils.fuzz import gen_register_history
lin = Linearizable("cas-register", device=sys.argv[1])
enc = lin.encode(gen_register_history(random.Random(0), n_ops=20,
                                      n_procs=3, p_info=0.0))
res, kernel = wk.check_batch_encoded_auto([enc], lin.model, lin.device)
if lin.device.type == "cuda":
    torch.cuda.synchronize(lin.device)
assert res[0]["valid"] is True, res
print("BACKEND_OK", kernel)
"""


def _env_float(var: str, default: float) -> float:
    try:
        return float(os.environ.get(var, ""))
    except ValueError:
        return default


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var, ""))
    except ValueError:
        return default


def probe_backend(timeout_s: float = PROBE_TIMEOUT_S,
                  device: str = "cuda") -> tuple[bool, str, bool]:
    """Check a small history on `device` in a subprocess with a hard
    timeout: a hung card can block its caller for good, so the probe must
    be killable from outside. Returns (ok, reason, timed_out): a timeout
    (the wedged signature) and a crash (reason carries the stderr tail)
    are different failures. The subprocess loads the library the parent
    built (ops/build.py), so on a healthy card it costs an interpreter
    start and one launch."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_CODE, device],
                             capture_output=True, text=True, env=env,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, (f"probe check on {device} exceeded {timeout_s:.0f}s "
                       f"— {TIMEOUT_MARKER}"), True
    except OSError as e:
        return False, f"could not spawn the probe: {e}", False
    if "BACKEND_OK" in out.stdout:
        return True, "", False
    return False, (f"probe exited {out.returncode} without completing a "
                   f"check on {device}; stderr tail: "
                   f"{out.stderr[-500:]}"), False


class BackendSupervisor:
    """The healthy/degraded/wedged state machine. Thread-safe: passive
    notes come from the corpus executor, stream consumer threads and
    handler threads at once. `device` is what the default probe checks
    on."""

    def __init__(self, probe: Optional[Callable] = None,
                 fail_degraded: Optional[int] = None,
                 fail_wedged: Optional[int] = None,
                 probe_timeout_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 device: str = "cuda"):
        self.fail_degraded = fail_degraded if fail_degraded is not None \
            else max(1, _env_int("JEPSEN_TPU_HEALTH_FAIL_DEGRADED", 1))
        self.fail_wedged = fail_wedged if fail_wedged is not None \
            else max(self.fail_degraded,
                     _env_int("JEPSEN_TPU_HEALTH_FAIL_WEDGED", 3))
        self.probe_timeout_s = probe_timeout_s if probe_timeout_s is not None \
            else _env_float("JEPSEN_TPU_HEALTH_PROBE_TIMEOUT_S",
                            PROBE_TIMEOUT_S)
        self.probe_interval_s = probe_interval_s \
            if probe_interval_s is not None \
            else _env_float("JEPSEN_TPU_HEALTH_PROBE_INTERVAL_S",
                            PROBE_INTERVAL_S)
        self._probe = probe or (
            lambda: probe_backend(timeout_s=self.probe_timeout_s,
                                  device=device))
        self._lock = threading.Lock()
        self.state = HEALTHY
        self._since_wall = time.time()
        self._consecutive_failures = 0
        self._ok_total = 0
        self._fail_total = 0
        self._probes_run = 0
        self._last_failure_reason: Optional[str] = None
        self._last_transition: Optional[dict] = None
        # The interval clock starts now: a fresh supervisor never probes
        # before probe_interval_s has passed.
        self._last_probe_mono = time.monotonic()

    # -- signals ----------------------------------------------------------

    def note_ok(self, source: str = "passive") -> None:
        """A backend interaction succeeded (a launch read back, a probe).
        Recovery is immediate: any success proves the card answers."""
        with self._lock:
            self._ok_total += 1
            self._consecutive_failures = 0
            if self.state != HEALTHY:
                self._transition(HEALTHY, f"backend interaction succeeded "
                                          f"({source})", source)

    def note_failure(self, reason: str, source: str = "passive",
                     wedged: bool = False) -> None:
        """A backend interaction failed. `wedged=True` (a probe timeout)
        goes straight to wedged; otherwise consecutive failures walk the
        thresholds."""
        with self._lock:
            self._fail_total += 1
            self._consecutive_failures += 1
            self._last_failure_reason = reason
            if wedged:
                if self.state != WEDGED:
                    self._transition(WEDGED, reason, source)
                return
            n = self._consecutive_failures
            if n >= self.fail_wedged and self.state != WEDGED:
                self._transition(
                    WEDGED, f"{n} consecutive failures "
                            f"(>= fail_wedged={self.fail_wedged}): "
                            f"{reason}", source)
            elif n >= self.fail_degraded and self.state == HEALTHY:
                self._transition(
                    DEGRADED, f"{n} consecutive failure(s) "
                              f"(>= fail_degraded={self.fail_degraded}): "
                              f"{reason}", source)

    def probe(self, source: str = "probe") -> bool:
        """Run the probe now and fold the outcome in."""
        with self._lock:
            self._probes_run += 1
            self._last_probe_mono = time.monotonic()
        ok, reason, timed_out = self._probe()
        if ok:
            self.note_ok(source=f"{source}:probe-ok")
        else:
            self.note_failure(reason, source=source, wedged=timed_out)
        return ok

    def maybe_probe(self, source: str = "periodic") -> Optional[bool]:
        """Rate-limited active probe: runs only when probe_interval_s has
        passed since the last probe (or construction) and
        JEPSEN_TPU_HEALTH_PROBE is not 0. Returns the outcome, or None
        when skipped (one lock and one clock read)."""
        with self._lock:
            if time.monotonic() - self._last_probe_mono \
                    < self.probe_interval_s:
                return None
        if os.environ.get("JEPSEN_TPU_HEALTH_PROBE", "1").lower() \
                in ("0", "false", "no", "off"):
            return None
        return self.probe(source=source)

    # -- state ------------------------------------------------------------

    def _transition(self, to: str, reason: str, source: str) -> None:
        """Record a state change (the caller holds the lock)."""
        frm = self.state
        self.state = to
        self._since_wall = time.time()
        self._last_transition = {
            "from": frm, "to": to, "reason": reason, "source": source,
            "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        }
        from . import get_metrics

        get_metrics().gauge("health.state").set(STATE_LEVEL[to])

    def snapshot(self) -> dict:
        """The /healthz view: the state with its last transition and the
        signal counters."""
        with self._lock:
            return {
                "state": self.state,
                "since": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime(self._since_wall)),
                "consecutive_failures": self._consecutive_failures,
                "ok_total": self._ok_total,
                "fail_total": self._fail_total,
                "probes_run": self._probes_run,
                "last_failure": self._last_failure_reason,
                "last_transition": dict(self._last_transition)
                if self._last_transition else None,
                "thresholds": {"fail_degraded": self.fail_degraded,
                               "fail_wedged": self.fail_wedged,
                               "probe_timeout_s": self.probe_timeout_s,
                               "probe_interval_s": self.probe_interval_s},
            }


_supervisor_lock = threading.Lock()
_supervisor: Optional[BackendSupervisor] = None


def get_supervisor() -> BackendSupervisor:
    """The process-wide supervisor (created on first use, when the
    environment knobs are read)."""
    global _supervisor
    with _supervisor_lock:
        if _supervisor is None:
            _supervisor = BackendSupervisor()
        return _supervisor


def reset_supervisor(sup: Optional[BackendSupervisor] = None
                     ) -> Optional[BackendSupervisor]:
    """Swap (or clear) the process supervisor; returns the previous one.
    `serve --check --device cpu` installs one that probes the host;
    tests install fake-probe supervisors."""
    global _supervisor
    with _supervisor_lock:
        prev, _supervisor = _supervisor, sup
        return prev
