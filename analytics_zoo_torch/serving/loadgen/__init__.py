"""Adversarial traffic simulation harness (port of the JAX package's
``serving/loadgen/``).

``loadgen``   — open-loop, coordinated-omission-safe request
                injection over the Redis bulk path, the HTTP fast
                path, and streaming ``/generate``.
``scenarios`` — the declarative phase/event DSL + canned storms
                (``diurnal``, ``flash_burst_with_outage``,
                ``poison_flood_drain``).
``verdict``   — end-of-run SLO assertions joined across the loadgen
                log, the dead-letter stream, and the supervisor's
                trajectory, plus the capacity-planning report.
"""

from analytics_zoo_torch.serving.loadgen.loadgen import (  # noqa: F401
    LoadGenerator, LoadgenRun, PayloadFactory, RequestRecord,
    ScheduledRequest)
from analytics_zoo_torch.serving.loadgen.scenarios import (  # noqa: F401
    SCENARIOS, Phase, PinnedRequest, Scenario, ScenarioEvent,
    default_hooks, diurnal, flash_burst_with_outage,
    poison_flood_drain, run_scenario)
from analytics_zoo_torch.serving.loadgen.verdict import (  # noqa: F401
    CheckResult, SloSpec, Verdict, capacity_report, evaluate,
    fleet_snapshot, pending_count, read_dead_letters,
    report_document, run_series_store, write_report)
