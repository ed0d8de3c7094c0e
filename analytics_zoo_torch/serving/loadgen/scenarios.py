"""Declarative traffic-scenario DSL + the canned adversarial storms.

A :class:`Scenario` is a list of :class:`Phase`\\ s (each a rate —
possibly ramping — over a duration, with endpoint / transport /
request-kind mixes and a heavy-tail knob), a list of *pinned*
requests (exact offsets for traffic the verdict must be able to
reason about deterministically, e.g. "exactly two poison records at
burst+0.4s"), and a list of :class:`ScenarioEvent`\\ s that fire
against the chaos machinery mid-run (broker outage windows, replica
kills, arbitrary :class:`~analytics_zoo_torch.resilience.chaos
.FaultSpec` plans).

Everything is generated from ONE seeded RNG, so a scenario is
replayable: the same seed produces the same arrival offsets, the same
mix draws, the same pinned traffic — a failed verdict can be re-run
bit-identically.  ``compress`` scales *durations and event offsets*
only; rates are absolute (a 10× flash burst must exceed the fleet's
capacity whether the scenario runs for a minute or for four seconds).

``run_scenario`` wires a scenario to a :class:`~.loadgen
.LoadGenerator`: events become timeline callbacks through a *hook
table*, so the same scenario runs against an in-process worker
(default hooks script the ``serving.redis`` chaos site) or a real
supervised fleet (the test/CLI overrides ``broker_outage`` with a
real TCP-broker stop/restart and ``kill_replica`` with a SIGKILL).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_torch.serving.loadgen.loadgen import (
    LoadGenerator, LoadgenRun, ScheduledRequest)
from analytics_zoo_torch.serving.loadgen.verdict import SloSpec

log = logging.getLogger("analytics_zoo_torch.serving.loadgen")


def _weighted(rng: np.random.RandomState,
              mix: Dict[str, float]) -> str:
    names = sorted(mix)
    weights = np.asarray([float(mix[n]) for n in names], np.float64)
    weights = weights / weights.sum()
    return names[int(rng.choice(len(names), p=weights))]


@dataclasses.dataclass
class Phase:
    """One traffic regime.  ``rate_rps`` → ``rate_end_rps`` ramps
    linearly across the phase (equal = steady).  ``heavy_tail`` mixes
    Pareto-multiplied gaps into the Poisson arrivals — the bursty
    think-time profile real users have and uniform load tools don't."""
    name: str
    duration_s: float
    rate_rps: float
    rate_end_rps: Optional[float] = None
    endpoints: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"default": 1.0})
    transports: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"redis": 1.0})
    kinds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"ok": 1.0})
    heavy_tail: float = 0.1
    max_tokens: Optional[int] = None

    def arrivals(self, rng: np.random.RandomState,
                 compress: float) -> List[float]:
        """Offsets WITHIN the (compressed) phase."""
        duration = self.duration_s * compress
        end_rate = (self.rate_rps if self.rate_end_rps is None
                    else self.rate_end_rps)
        out, t = [], 0.0
        while t < duration:
            frac = t / duration if duration else 1.0
            rate = self.rate_rps + (end_rate - self.rate_rps) * frac
            if rate <= 0:
                break
            gap = rng.exponential(1.0 / rate)
            if self.heavy_tail > 0 and rng.random() < self.heavy_tail:
                # a heavy-tailed pause: most users click steadily,
                # some wander off and come back in a burst
                gap *= 1.0 + rng.pareto(1.5)
            t += gap
            if t < duration:
                out.append(t)
        return out


@dataclasses.dataclass
class ScenarioEvent:
    """A scripted mid-run action: ``kind`` names a hook
    (``broker_outage`` | ``kill_replica`` | ``chaos``), ``at_s`` is
    the uncompressed offset, ``duration_s`` > 0 fires the hook again
    with ``edge="end"`` when the window closes."""
    at_s: float
    kind: str
    duration_s: float = 0.0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PinnedRequest:
    """A request at an EXACT offset (uncompressed), for traffic the
    verdict asserts on individually (the poison record that must be
    quarantined after exactly N deliveries)."""
    at_s: float
    kind: str = "ok"
    endpoint: str = "default"
    transport: str = "redis"
    max_tokens: Optional[int] = None


class Scenario:
    """Phases + pins + events + the SLO this scenario must meet.

    ``objectives`` are declarative :class:`~analytics_zoo_torch
    .observability.slo.SloObjective` specs (or YAML entries loadable
    via ``--slo-spec``): the verdict evaluates each over the run's
    recorded window with the production burn-rate math and emits one
    ``slo:<name>`` check per objective.  Default scenarios declare
    none — a spec is an opt-in claim, not a free pass."""

    def __init__(self, name: str, phases: Sequence[Phase],
                 events: Sequence[ScenarioEvent] = (),
                 pins: Sequence[PinnedRequest] = (),
                 seed: int = 0, slo: Optional[SloSpec] = None,
                 objectives: Sequence[Any] = ()):
        self.name = name
        self.phases = list(phases)
        self.events = sorted(events, key=lambda e: e.at_s)
        self.pins = list(pins)
        self.seed = int(seed)
        self.slo = slo or SloSpec()
        self.objectives = list(objectives)

    # ------------------------------------------------------------- geometry
    def duration_s(self, compress: float = 1.0) -> float:
        return sum(p.duration_s for p in self.phases) * compress

    def phase_window(self, name: str, compress: float = 1.0):
        """(start, end) offsets of a named phase — the verdict anchors
        the autoscaler lag bound on the burst phase's start."""
        t = 0.0
        for p in self.phases:
            end = t + p.duration_s * compress
            if p.name == name:
                return t, end
            t = end
        raise KeyError(f"no phase {name!r} in scenario {self.name!r}")

    # ------------------------------------------------------------- schedule
    def schedule(self, compress: float = 1.0
                 ) -> List[ScheduledRequest]:
        rng = np.random.RandomState(self.seed)
        out: List[ScheduledRequest] = []
        t = 0.0
        for phase in self.phases:
            for off in phase.arrivals(rng, compress):
                out.append(ScheduledRequest(
                    offset_s=t + off,
                    endpoint=_weighted(rng, phase.endpoints),
                    transport=_weighted(rng, phase.transports),
                    kind=_weighted(rng, phase.kinds),
                    max_tokens=phase.max_tokens,
                    phase=phase.name))
            t += phase.duration_s * compress
        for pin in self.pins:
            out.append(ScheduledRequest(
                offset_s=pin.at_s * compress, endpoint=pin.endpoint,
                transport=pin.transport, kind=pin.kind,
                max_tokens=pin.max_tokens, phase="pinned"))
        out.sort(key=lambda s: s.offset_s)
        return out


# ------------------------------------------------------- event hook table
def default_hooks() -> Dict[str, Callable]:
    """In-process hooks: events script the existing chaos sites.  A
    ``broker_outage`` window arms ``serving.redis`` to fail every
    attempted broker op until the window closes (the worker's breaker
    opens, fast-fails, and recovers via its half-open probe — the
    serving chaos contract, now scriptable from a scenario timeline)."""
    from analytics_zoo_torch.resilience.chaos import (
        SITE_SERVING_REDIS, ChaosPlan, FaultSpec, install_chaos)
    state: Dict[str, Any] = {}

    def broker_outage(event: ScenarioEvent, edge: str) -> None:
        if edge == "start":
            state["prev"] = install_chaos(ChaosPlan([FaultSpec(
                site=SITE_SERVING_REDIS, at_step=0, kind="raise",
                times=10 ** 9,
                message="scenario broker outage window")]))
        else:
            install_chaos(state.pop("prev", None))

    def chaos(event: ScenarioEvent, edge: str) -> None:
        if edge == "start":
            state.setdefault("chaos_prev", []).append(install_chaos(
                ChaosPlan([FaultSpec.from_dict(d)
                           for d in event.params.get("faults", [])])))
        elif state.get("chaos_prev"):
            install_chaos(state["chaos_prev"].pop())

    def kill_replica(event: ScenarioEvent, edge: str) -> None:
        log.warning("scenario event kill_replica ignored: no fleet "
                    "hook installed (in-process run)")

    return {"broker_outage": broker_outage, "chaos": chaos,
            "kill_replica": kill_replica}


def run_scenario(scenario: Scenario, *, compress: float = 1.0,
                 hooks: Optional[Dict[str, Callable]] = None,
                 **loadgen_kwargs) -> LoadgenRun:
    """Build the schedule, wire the events through the hook table,
    and run the load generator.  ``hooks`` entries override the
    in-process defaults (a fleet test passes a real broker
    stop/restart and a real replica SIGKILL)."""
    table = default_hooks()
    table.update(hooks or {})
    schedule = scenario.schedule(compress)
    events = []
    for ev in scenario.events:
        hook = table.get(ev.kind)
        if hook is None:
            log.warning("no hook for scenario event kind %r; skipped",
                        ev.kind)
            continue

        def _fire(hook=hook, ev=ev, edge="start"):
            hook(ev, edge)
        events.append((ev.at_s * compress, _fire))
        if ev.duration_s > 0:
            def _end(hook=hook, ev=ev):
                hook(ev, "end")
            events.append(((ev.at_s + ev.duration_s) * compress,
                           _end))
    gen = LoadGenerator(schedule, **loadgen_kwargs)
    return gen.run(events=events)


# ---------------------------------------------------------- canned storms
def diurnal(*, base_rate: float = 4.0, peak_rate: float = 30.0,
            period_s: float = 12.0, transport: str = "redis",
            seed: int = 7, slo: Optional[SloSpec] = None) -> Scenario:
    """A compressed day: ramp to peak, hold, ramp back down.  No
    faults — this is the capacity-planning scenario (the ramp sweeps
    offered load through the knee, which is exactly the data the
    replicas-per-rps fit needs)."""
    third = period_s / 3.0
    mix = {transport: 1.0}
    return Scenario(
        "diurnal",
        phases=[
            Phase("ramp_up", third, base_rate, peak_rate,
                  transports=mix),
            Phase("peak", third, peak_rate, transports=mix),
            Phase("ramp_down", third, peak_rate, base_rate,
                  transports=mix),
        ],
        seed=seed,
        slo=slo or SloSpec(p99_from_scheduled_ms=5000.0))


def flash_burst_with_outage(*, base_rate: float = 6.0,
                            burst_mult: float = 10.0,
                            warmup_s: float = 3.0,
                            burst_s: float = 5.0,
                            drain_s: float = 3.0,
                            outage_after_s: float = 1.0,
                            outage_s: float = 1.2,
                            poison: int = 1,
                            transport: str = "redis",
                            seed: int = 11,
                            slo: Optional[SloSpec] = None) -> Scenario:
    """The acceptance storm: steady warmup, a 10× flash burst with a
    broker outage window opening mid-burst, poison pinned inside the
    burst, then a slow drain.  A correct fleet rides the outage on
    the breaker, scales up on the burst backlog without flapping,
    quarantines the poison at exactly ``poison_max_attempts``
    deliveries, and loses nothing."""
    mix = {transport: 1.0}
    burst_start = warmup_s
    pins = [PinnedRequest(at_s=burst_start + 0.4 + 0.2 * i,
                          kind="poison", transport=transport)
            for i in range(poison)]
    return Scenario(
        "flash_burst_with_outage",
        phases=[
            Phase("warmup", warmup_s, base_rate, transports=mix),
            Phase("burst", burst_s, base_rate * burst_mult,
                  transports=mix, heavy_tail=0.15),
            Phase("drain", drain_s, base_rate / 2.0, transports=mix),
        ],
        events=[ScenarioEvent(at_s=burst_start + outage_after_s,
                              kind="broker_outage",
                              duration_s=outage_s)],
        pins=pins,
        seed=seed,
        slo=slo or SloSpec(p99_from_scheduled_ms=15000.0,
                           scale_up_lag_s=None))


def poison_flood_drain(*, base_rate: float = 8.0, steady_s: float = 2.5,
                       flood_s: float = 4.0, drain_s: float = 2.5,
                       flood_poison: float = 0.2,
                       flood_malformed: float = 0.2,
                       transport: str = "redis",
                       seed: int = 13,
                       slo: Optional[SloSpec] = None) -> Scenario:
    """A hostile-client flood: healthy steady-state, then a window
    where a fifth of the traffic is poison and another fifth is
    undecodable garbage, then back to healthy.  The verdict checks
    that every hostile record got an explicit terminal outcome (error
    result / quarantine — never silence), no poison resolved ok, and
    the healthy co-traffic still completed."""
    mix = {transport: 1.0}
    ok = max(1.0 - flood_poison - flood_malformed, 0.0)
    return Scenario(
        "poison_flood_drain",
        phases=[
            Phase("steady", steady_s, base_rate, transports=mix),
            Phase("flood", flood_s, base_rate * 2.0, transports=mix,
                  kinds={"ok": ok, "poison": flood_poison,
                         "malformed": flood_malformed}),
            Phase("drain", drain_s, base_rate, transports=mix),
        ],
        seed=seed,
        slo=slo or SloSpec(p99_from_scheduled_ms=15000.0,
                           max_error_fraction=1.0))


#: the canned registry the CLI and the storm bench run by name
SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "diurnal": diurnal,
    "flash_burst_with_outage": flash_burst_with_outage,
    "poison_flood_drain": poison_flood_drain,
}
