"""Workload scenarios + SLO-attainment evaluation harness (a copy of
``repro.workloads``; the harness serves through the port's engine).

Importing this package registers every built-in scenario. Public surface:

    Scenario / TenantSpec / LengthDist   the scenario spec (SLO tiers are
                                         plain core SLOSpec values)
    register_scenario     decorator, @register_scenario("my-scenario")
    make_scenario         name + kwargs -> Scenario-like
    generate_scenario     name -> List[Request] (one-shot)
    available_scenarios   every registered name
    ArrivalProcess + Poisson/MarkovModulated/Sinusoidal arrivals
    HarnessConfig / evaluate_cell / run_grid   the evaluation harness

See DESIGN.md §workloads.
"""
from repro_torch.workloads.arrivals import (
    ArrivalProcess,
    MarkovModulatedArrivals,
    PoissonArrivals,
    SinusoidalArrivals,
)
from repro_torch.workloads.harness import (
    BACKENDS,
    HarnessConfig,
    evaluate_cell,
    run_grid,
    to_engine_requests,
)
from repro_torch.workloads.scenarios import (
    DEFAULT_SLO_CLASSES,
    LengthDist,
    ReplayScenario,
    Scenario,
    TenantSpec,
    TraceConfigScenario,
    available_scenarios,
    generate_scenario,
    make_scenario,
    register_scenario,
)

__all__ = [
    "ArrivalProcess",
    "MarkovModulatedArrivals",
    "PoissonArrivals",
    "SinusoidalArrivals",
    "BACKENDS",
    "HarnessConfig",
    "evaluate_cell",
    "run_grid",
    "to_engine_requests",
    "DEFAULT_SLO_CLASSES",
    "LengthDist",
    "ReplayScenario",
    "Scenario",
    "TenantSpec",
    "TraceConfigScenario",
    "available_scenarios",
    "generate_scenario",
    "make_scenario",
    "register_scenario",
]
