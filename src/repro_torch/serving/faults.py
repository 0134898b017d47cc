"""Execution-level fault injection + failure-domain primitives.

The port's own copy of ``repro/serving/faults.py`` (numpy only; the port
imports nothing of ``repro``).  The gateway builds ``RetryPolicy``,
``CircuitBreaker`` and ``HealthRegistry`` on every call and the swarm
catches ``MemberDownError``; ``FaultPlan`` rides along so chaos runs go
through the gateway, while the port's ``serve(faults=...)`` still raises.

serving/simulator.py perturbs *latency accounting* (a down member costs
nothing, a WAN outage reroutes); this module makes failures happen in
*execution*: a member's generate/serve raises mid-round, the cloud call
times out, the pool refuses blocks, a live session is evicted.  The
resilience layer (gateway retry/breaker, swarm casualty salvage, serve
backpressure) is exercised against these injected faults and must keep
every query answered.

Three pieces:

* a typed exception hierarchy rooted at ``ServingFault(RuntimeError)`` —
  ``PoolExhaustedError`` replaces the bare famine ``RuntimeError`` the
  cache pool used to raise (breaking change, see docs/RUNTIME.md);
* ``FaultPlan``: a deterministic, seeded schedule of ``FaultEvent``s,
  consulted at execution choke points (``call``/``consume``).  Determinism
  contract: the same plan spec + seed against the same workload produces
  the same injected faults, the same winners and the same counters —
  and an EMPTY plan (or ``faults=None``) leaves execution bitwise
  untouched, because no code path draws from ``plan.rng`` or consults
  the schedule result unless an event actually fires;
* retry/health machinery the gateway composes: ``RetryPolicy`` (bounded
  attempts, deadline, jittered exponential backoff), ``CircuitBreaker``
  (closed -> open -> half-open over gateway ticks), ``HealthRegistry``
  (per-member EWMA latency + consecutive-failure count with half-open
  recovery probes, fed to ``scheduler.select_peers``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# Typed exception hierarchy
# ---------------------------------------------------------------------------

class ServingFault(RuntimeError):
    """Base of the serving failure domain.

    Subclasses ``RuntimeError`` so pre-existing ``except RuntimeError``
    call sites keep catching pool famine after the rename.
    """

    #: simulated seconds burned before the failure surfaced (e.g. a call
    #: that timed out consumed its full deadline).  Latency accounting
    #: adds this even though the call produced nothing.
    delay_s: float = 0.0


class MemberDownError(ServingFault):
    """A swarm member crashed / became unreachable mid-round."""

    def __init__(self, msg: str, member: int | None = None):
        super().__init__(msg)
        self.member = member


class CloudUnavailableError(ServingFault):
    """Cloud summon failed (timeout, transport error, or open breaker)."""


class PoolExhaustedError(ServingFault):
    """Block pool famine: no admission possible even after TTL eviction.

    Raised by ``CachePool.alloc_blocks`` and ``serve()``.
    """


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------

#: recognised (site, kind) combinations; ``member:<j>`` matches member j.
SITES = ("cloud", "member", "pool", "session", "slot", "decode")
KINDS = ("crash", "timeout", "error", "straggle", "famine", "evict", "fail")


@dataclasses.dataclass
class FaultEvent:
    """One scheduled failure.

    site:  "cloud" | "member:<j>" | "pool" | "session" | "slot" | "decode"
    kind:  "crash"    — call raises immediately (no latency burned)
           "timeout"  — call raises after burning ``delay_s`` (the caller's
                        deadline); retried by the gateway's RetryPolicy
           "error"    — transport error, raises immediately.  Flaky-then-
                        succeed is expressed with ``count`` < the caller's
                        retry budget: the first ``count`` calls fail, the
                        next succeeds.
           "straggle" — call succeeds but ``delay_s`` is added to its
                        realized latency ("decode" site: per decode chunk)
           "famine"   — ("pool") one admission round sees zero free blocks
           "evict"    — ("session") the next warm admission finds its
                        handle evicted (forces the cold re-prefill path)
           "fail"     — ("slot") the lowest active decode slot dies after
                        the current chunk; its request is requeued
    tick:  fire only at this plan tick (None = first opportunity)
    count: how many consecutive matching calls/rounds are affected
    delay_s: simulated seconds for timeout/straggle kinds
    """

    site: str
    kind: str
    tick: int | None = None
    count: int = 1
    delay_s: float = 0.0


class FaultPlan:
    """Deterministic, seeded schedule of execution faults.

    The plan is consulted at choke points, never wrapped around engines
    (the gateway's ``m is self.probe`` identity checks must keep working).
    ``call(site, fn, ...)`` is the main entry: it either runs ``fn`` (and
    reports any injected straggle delay) or raises the typed exception
    the site maps to.  ``consume(site)`` is the non-callable form for
    sites that gate control flow (famine, evict, slot).

    ``rng`` is plan-owned: retry backoff jitter draws from it so the
    simulator's RNG stream is untouched — a prerequisite for the
    "empty plan == bitwise pre-PR behavior" contract.
    """

    def __init__(self, events: list[FaultEvent] | tuple = (), seed: int = 0):
        self._spec = tuple(dataclasses.replace(e) for e in events)
        self.seed = seed
        self.reset()

    def reset(self):
        """Rewind to tick 0 with the original schedule (for determinism
        re-runs: same spec + seed -> same injections)."""
        self.events = [dataclasses.replace(e) for e in self._spec]
        self.rng = np.random.RandomState(self.seed)
        self._tick = 0
        self.counters: dict[str, int] = {}

    def tick(self):
        """Advance the plan clock (the gateway calls this once per batch)."""
        self._tick += 1

    @property
    def now(self) -> int:
        return self._tick

    # -- schedule queries ---------------------------------------------------
    def _match(self, site: str) -> FaultEvent | None:
        for ev in self.events:
            if ev.site == site and ev.count > 0 and (
                    ev.tick is None or ev.tick == self._tick):
                return ev
        return None

    def pending(self, site: str) -> bool:
        """Is a fault armed for this site at the current tick? (no consume)"""
        return self._match(site) is not None

    def consume(self, site: str) -> FaultEvent | None:
        """Pop one scheduled fault for ``site`` (None if none armed)."""
        ev = self._match(site)
        if ev is None:
            return None
        ev.count -= 1
        key = f"{site}:{ev.kind}"
        self.counters[key] = self.counters.get(key, 0) + 1
        return ev

    # -- the execution choke point -----------------------------------------
    def call(self, site: str, fn, *args, **kwargs):
        """Run ``fn`` at a fault site -> ``(result, injected_delay_s)``.

        Raises ``CloudUnavailableError`` (site "cloud") or
        ``MemberDownError`` (sites "member:<j>") when a crash/timeout/
        error event is armed; a "straggle" event lets the call through
        but reports its delay for latency accounting.
        """
        ev = self.consume(site)
        if ev is None:
            return fn(*args, **kwargs), 0.0
        if ev.kind == "straggle":
            return fn(*args, **kwargs), float(ev.delay_s)
        member = int(site.split(":", 1)[1]) if site.startswith("member:") else None
        cls = CloudUnavailableError if site == "cloud" else MemberDownError
        err = (cls(f"injected {ev.kind} at {site} (tick {self._tick})")
               if member is None else
               cls(f"injected {ev.kind} at {site} (tick {self._tick})", member))
        err.delay_s = float(ev.delay_s) if ev.kind == "timeout" else 0.0
        raise err

    # -- seeded schedule generation ----------------------------------------
    @classmethod
    def random(cls, seed: int, n_members: int, ticks: int, *,
               p_member_crash: float = 0.05, p_cloud_fail: float = 0.05,
               p_straggle: float = 0.1, p_famine: float = 0.0,
               straggle_s: float = 1.0, timeout_s: float = 8.0) -> "FaultPlan":
        """Draw a deterministic schedule from ``seed`` (chaos harnesses)."""
        rng = np.random.RandomState(seed)
        events: list[FaultEvent] = []
        for t in range(1, ticks + 1):
            for j in range(n_members):
                r = rng.rand()
                if r < p_member_crash:
                    events.append(FaultEvent(f"member:{j}", "crash", tick=t))
                elif r < p_member_crash + p_straggle:
                    events.append(FaultEvent(f"member:{j}", "straggle",
                                             tick=t, delay_s=straggle_s))
            if rng.rand() < p_cloud_fail:
                events.append(FaultEvent("cloud", "timeout", tick=t,
                                         delay_s=timeout_s))
            if rng.rand() < p_famine:
                events.append(FaultEvent("pool", "famine", tick=t))
        return cls(events, seed=seed)


# ---------------------------------------------------------------------------
# Retry / breaker / health
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with deadline + jittered exponential backoff.

    ``timeout_s`` is the per-attempt deadline: a summon that fails with a
    timeout burns the full deadline before the next attempt; backoff
    sleeps are added on top.  All of it is *simulated* time fed into the
    Eq. 9-style latency accounting — nothing actually sleeps.
    """

    max_attempts: int = 3
    timeout_s: float = 8.0
    backoff_base_s: float = 0.25
    backoff_mult: float = 2.0
    jitter: float = 0.25          # +/- fraction of the nominal backoff

    def backoff(self, attempt: int, rng: np.random.RandomState | None = None
                ) -> float:
        """Backoff before retry #``attempt`` (0-indexed: after failure 1)."""
        b = self.backoff_base_s * self.backoff_mult ** attempt
        if rng is not None and self.jitter > 0:
            b *= 1.0 + self.jitter * (2.0 * rng.rand() - 1.0)
        return float(b)


class CircuitBreaker:
    """Cloud-summon circuit breaker over gateway batch ticks.

    closed -> (``fail_threshold`` consecutive exhausted summons) -> open
    -> (``cooldown_ticks`` later) -> half-open: one probe summon is let
    through; success re-closes, failure re-opens.  While open,
    ``allow() == False`` degrades routing exactly like a WAN outage
    (``wan_ok`` and the breaker AND into one ``cloud_ok`` signal).
    """

    def __init__(self, fail_threshold: int = 1, cooldown_ticks: int = 2):
        self.fail_threshold = fail_threshold
        self.cooldown_ticks = cooldown_ticks
        self.reset()

    def reset(self):
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at = -1
        self.opened_count = 0

    def allow(self, tick: int) -> bool:
        if self.state == "open":
            if tick - self.opened_at >= self.cooldown_ticks:
                self.state = "half-open"
                return True
            return False
        return True

    def record_success(self):
        self.state = "closed"
        self.consecutive_failures = 0

    def record_failure(self, tick: int):
        self.consecutive_failures += 1
        if (self.state == "half-open"
                or self.consecutive_failures >= self.fail_threshold):
            self.state = "open"
            self.opened_at = tick
            self.opened_count += 1


class HealthRegistry:
    """Per-member health: EWMA latency + consecutive-failure count.

    A member whose consecutive failures reach ``fail_threshold`` stops
    being ``available()`` — except every ``probe_interval`` ticks, when
    it is offered as a half-open recovery probe; one success restores it.
    ``scheduler.select_peers(..., health=...)`` masks selection with
    ``available()`` and uses the EWMA as the latency prior where known.
    """

    def __init__(self, n: int, alpha: float = 0.3, fail_threshold: int = 2,
                 probe_interval: int = 3):
        self.n = n
        self.alpha = alpha
        self.fail_threshold = fail_threshold
        self.probe_interval = probe_interval
        self.ewma = np.full((n,), np.nan)
        self.fails = np.zeros((n,), np.int64)
        self._tick = 0
        self._down_at = np.full((n,), -1, np.int64)

    def tick(self):
        self._tick += 1

    def record_success(self, j: int, latency_s: float | None = None):
        self.fails[j] = 0
        self._down_at[j] = -1
        if latency_s is not None:
            self.ewma[j] = (latency_s if np.isnan(self.ewma[j]) else
                            self.alpha * latency_s
                            + (1 - self.alpha) * self.ewma[j])

    def record_failure(self, j: int):
        self.fails[j] += 1
        if self.fails[j] == self.fail_threshold:
            self._down_at[j] = self._tick

    def healthy(self) -> np.ndarray:
        return self.fails < self.fail_threshold

    def available(self) -> np.ndarray:
        """Healthy members, plus unhealthy ones due a half-open probe."""
        h = self.healthy()
        since = self._tick - self._down_at
        probe = (~h) & (self._down_at >= 0) & (since > 0) \
            & (since % self.probe_interval == 0)
        return h | probe
