"""The port's host modules of the evaluation harness against the JAX
package's: ``sim.trace``, ``workloads.{arrivals,scenarios}``,
``core.pacer``, ``sim.simulator`` (``run_policy`` under four policy pairs,
with a fault plan and a trace recorder), ``sim.metrics`` and
``sim.costmodel``. They are copies of the same numpy code, so the same seed
gives equal requests and equal metrics, compared with ``==`` on floats;
then torch twins of the reference's invariant tests that no parity case
covers (tests/test_sim_end2end.py, tests/test_workloads_scenarios.py,
tests/test_trace_and_pacer_property.py)."""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.pacer import DeliveryPacer as JaxDeliveryPacer  # noqa: E402
from repro.obs.events import TraceRecorder as JaxTraceRecorder  # noqa: E402
from repro.sim import costmodel as jax_costmodel  # noqa: E402
from repro.sim import metrics as jax_metrics  # noqa: E402
from repro.sim import simulator as jax_simulator  # noqa: E402
from repro.sim import trace as jax_trace  # noqa: E402
from repro.workloads import arrivals as jax_arrivals  # noqa: E402
from repro.workloads import scenarios as jax_scenarios  # noqa: E402
from repro_torch.core import DeliveryPacer  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.obs.events import TraceRecorder  # noqa: E402
from repro_torch.sim import costmodel, metrics, simulator, trace  # noqa: E402
from repro_torch.sim.costmodel import PAPER_COST_MODEL, check_calibration  # noqa: E402
from repro_torch.sim.metrics import attainment, attainment_by, compare, goodput, summarize  # noqa: E402
from repro_torch.sim.simulator import FaultPlan, SimConfig, run_kairos, run_policy  # noqa: E402
from repro_torch.sim.trace import TraceConfig, generate_trace, load_trace, save_trace  # noqa: E402
from repro_torch.workloads import arrivals, scenarios  # noqa: E402
from repro_torch.workloads import (  # noqa: E402
    MarkovModulatedArrivals,
    PoissonArrivals,
    Scenario,
    SinusoidalArrivals,
    TenantSpec,
    available_scenarios,
    generate_scenario,
    make_scenario,
)


def _state(r):
    """Every field of a request, the phase by value (the enums are two
    classes), so requests of the two packages compare with ``==``."""
    d = dataclasses.asdict(r)
    d["phase"] = r.phase.value
    return d


def _states(reqs):
    return [_state(r) for r in reqs]


def _jax_twins(reqs):
    """The port's requests as JAX requests, field for field."""
    from repro.core.request import Phase as JPhase
    from repro.core.request import Request as JRequest
    from repro.core.request import SLOSpec as JSLOSpec

    out = []
    for r in reqs:
        d = _state(r)
        d["slo"] = JSLOSpec(**d["slo"])
        d["phase"] = JPhase(d["phase"])
        out.append(JRequest(**d))
    return out


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("seed, qps, n", [(0, 3.0, 200), (7, 0.5, 50), (11, 9.0, 120)])
def test_generate_trace_equals_the_jax_packages(seed, qps, n):
    a = jax_trace.generate_trace(jax_trace.TraceConfig(n_requests=n, qps=qps, seed=seed))
    b = trace.generate_trace(TraceConfig(n_requests=n, qps=qps, seed=seed))
    assert _states(a) == _states(b)
    assert jax_trace.trace_stats(a) == trace.trace_stats(b)


def _replay_file(tmp_path):
    p = tmp_path / "replay.jsonl"
    save_trace(str(p), generate_scenario("multi-tenant", seed=5, n_requests=30))
    return str(p)


@pytest.mark.parametrize("name", jax_scenarios.available_scenarios())
def test_every_scenario_generates_the_jax_packages_requests(name, tmp_path):
    assert scenarios.available_scenarios() == jax_scenarios.available_scenarios()
    kw = {"path": _replay_file(tmp_path)} if name == "replay" else {"n_requests": 60}
    for seed in (0, 3):
        a = jax_scenarios.make_scenario(name, **kw).generate(seed)
        b = scenarios.make_scenario(name, **kw).generate(seed)
        assert _states(a) == _states(b)


@pytest.mark.parametrize("proc", [
    ("PoissonArrivals", dict(qps=2.5)),
    ("MarkovModulatedArrivals", dict()),
    ("MarkovModulatedArrivals", dict(qps_on=20.0, qps_off=0.0, mean_on=1.0, mean_off=9.0)),
    ("SinusoidalArrivals", dict()),
    ("SinusoidalArrivals", dict(amplitude=0.9, period=30.0)),
], ids=lambda p: f"{p[0]}{sorted(p[1].items())}")
def test_arrival_processes_equal_the_jax_packages(proc):
    name, kw = proc
    a = getattr(jax_arrivals, name)(**kw).times(300, np.random.default_rng(4))
    b = getattr(arrivals, name)(**kw).times(300, np.random.default_rng(4))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode, frac", [("immediate", 0.9), ("paced", 0.9), ("paced", 0.5)])
def test_pacer_equals_the_jax_packages(mode, frac):
    rng = np.random.default_rng(1)
    jp, tp = JaxDeliveryPacer(mode=mode, pace_fraction=frac), DeliveryPacer(mode=mode,
                                                                          pace_fraction=frac)
    for _ in range(20):
        times = sorted(rng.uniform(0, 5, rng.integers(1, 30)).tolist())
        tpot = float(rng.uniform(0.01, 0.2))
        assert jp.delivery_times(times, times[0], tpot) == tp.delivery_times(times, times[0],
                                                                             tpot)
        for t_now in (times[0], times[-1] / 2, times[-1] + 1):
            assert jp.banked(times, t_now, times[0], tpot) == tp.banked(times, t_now, times[0],
                                                                       tpot)


def _sim_fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name not in ("requests", "config")}


@pytest.mark.parametrize("prefill, decode", [
    ("kairos-urgency", "kairos-slack"),
    ("fcfs", "continuous"),
    ("kairos-urgency-plus", "kairos-slack-greedy"),
    ("kairos-urgency-plus", "kairos-slack"),
    ("sjf", "continuous"),
    ("edf", "continuous"),
    ("srpt", "continuous"),
    ("cache-aware", "continuous"),
])
def test_run_policy_equals_the_jax_packages(prefill, decode):
    """Same trace, same policy pair, a decode failure, lognormal step noise
    and a prefix-cache share: equal requests, equal `SimResult` counters,
    equal metrics and equal event streams."""
    reqs = generate_trace(TraceConfig(n_requests=150, qps=3.0, seed=2))
    cfg = dict(step_noise_sigma=0.1, prefix_cache_hit_frac=0.2, pacer_mode="paced", seed=3)
    faults = dict(decode_failures=(12.0,), recovery_time=2.0)
    jtr, ttr = JaxTraceRecorder(), TraceRecorder()
    a = jax_simulator.run_policy(_jax_twins(reqs), prefill, decode,
                                 sim_cfg=jax_simulator.SimConfig(**cfg),
                                 fault_plan=jax_simulator.FaultPlan(**faults), trace=jtr)
    b = run_policy(reqs, prefill, decode, sim_cfg=SimConfig(**cfg),
                   fault_plan=FaultPlan(**faults), trace=ttr)
    assert _states(a.requests) == _states(b.requests)
    assert _sim_fields(a) == _sim_fields(b)
    assert sum(r.restarts for r in b.requests) > 0  # the fault caught requests
    assert jax_metrics.summarize(a) == summarize(b)
    assert jax_metrics.attainment(a.requests).as_dict() == attainment(b.requests).as_dict()
    assert jax_metrics.goodput(a.requests) == goodput(b.requests)
    assert [e.as_dict() for e in jtr.events] == [e.as_dict() for e in ttr.events]


def _seeded_queue(rng):
    """A queue that sets every field the prefill policies read: some
    requests part prefilled or with a cached prefix head, some with tokens
    already generated (a restart), SLOs and lengths drawn from small sets so
    that scores tie and the rid tiebreak decides."""
    out = []
    for rid in rng.permutation(int(rng.integers(1, 16))):
        input_len = int(rng.choice([1, 64, 512, 2048, int(rng.integers(1, 8192))]))
        cached = int(rng.integers(0, input_len + 1)) if rng.random() < 0.4 else 0
        done = int(rng.integers(0, input_len - cached + 1)) if rng.random() < 0.4 else 0
        output_len = int(rng.choice([1, 16, 256]))
        out.append(Request(
            rid=int(rid), arrival=float(rng.choice([0.0, 0.5, float(rng.uniform(0, 4))])),
            input_len=input_len, output_len=output_len,
            slo=SLOSpec(ttft=float(rng.choice([0.5, 2.0, 8.0])), tpot=0.05),
            phase=Phase.PREFILL if done else Phase.QUEUED, prefilled_tokens=done,
            prefix_cached_tokens=cached,
            n_generated=int(rng.integers(0, output_len)) if rng.random() < 0.3 else 0))
    return out


@pytest.mark.parametrize("name", ["sjf", "edf", "srpt", "cache-aware", "fcfs",
                                  "kairos-urgency", "kairos-urgency-plus"])
def test_prefill_select_equals_the_jax_packages(name):
    """`make_prefill(name).select` of both packages over 200 seeded queues:
    the same (rid, tokens) chunks in the same order."""
    from repro.policies import available_prefill_policies as jax_prefill_policies
    from repro.policies import make_prefill as jax_make_prefill
    from repro_torch.policies import available_prefill_policies, make_prefill

    assert set(available_prefill_policies()) == set(jax_prefill_policies())
    assert name in available_prefill_policies()
    a, b = jax_make_prefill(name), make_prefill(name)
    rng = np.random.default_rng(26)
    for _ in range(200):
        queue = _seeded_queue(rng)
        t_now = float(rng.uniform(0, 6))
        mu = float(rng.choice([500.0, 4000.0, float(rng.uniform(50, 20000))]))
        budget = int(rng.choice([1, 512, 8192, int(rng.integers(1, 20000))]))
        want = [(r.rid, n) for r, n in a.select(_jax_twins(queue), t_now, mu, budget)]
        got = [(r.rid, n) for r, n in b.select(queue, t_now, mu, budget)]
        assert got == want, (name, t_now, mu, budget)
        assert sum(n for _, n in got) <= budget


def test_run_kairos_distserve_and_plus_equal_the_jax_packages():
    reqs = generate_trace(TraceConfig(n_requests=80, qps=3.0, seed=1))
    for name in ("run_kairos", "run_distserve", "run_kairos_plus"):
        a = getattr(jax_simulator, name)(_jax_twins(reqs))
        b = getattr(simulator, name)(reqs)
        assert _states(a.requests) == _states(b.requests), name
        assert _sim_fields(a) == _sim_fields(b), name
    ka, da = (jax_simulator.run_kairos(_jax_twins(reqs)),
              jax_simulator.run_distserve(_jax_twins(reqs)))
    assert jax_metrics.compare(ka, da) == compare(run_kairos(reqs),
                                                  simulator.run_distserve(reqs))


def test_metrics_by_group_and_pool_equal_the_jax_packages():
    reqs = generate_scenario("multi-tenant", seed=2, n_requests=60)
    b = run_policy(reqs, "kairos-urgency", "kairos-slack").requests
    for r in b[::7]:
        r.phase = Phase.FAILED  # shed
    for r in b[3::11]:
        r.phase = Phase.CANCELLED
    a = _jax_twins(b)
    for key in ("tenant", "slo_class"):
        ja, ta = jax_metrics.attainment_by(a, key), attainment_by(b, key)
        assert {k: v.as_dict() for k, v in ja.items()} == {k: v.as_dict() for k, v in ta.items()}
    labels = {r.rid: f"pool{r.rid % 3}" for r in b}
    ja, ta = jax_metrics.attainment_by_pool(a, labels), metrics.attainment_by_pool(b, labels)
    assert {k: v.as_dict() for k, v in ja.items()} == {k: v.as_dict() for k, v in ta.items()}
    assert jax_metrics.attainment(a, done_only=True) .as_dict() == attainment(
        b, done_only=True).as_dict()
    assert jax_metrics.goodput(a, span=3.0) == goodput(b, span=3.0)


def test_cost_model_equals_the_jax_packages():
    assert dataclasses.asdict(jax_costmodel.PAPER_COST_MODEL) == dataclasses.asdict(
        PAPER_COST_MODEL)
    assert jax_costmodel.check_calibration() == check_calibration()
    assert not hasattr(costmodel, "TPUCostModel")  # TPU v5e coefficients stay out


def test_save_and_load_trace_round_trip_across_the_packages(tmp_path):
    reqs = generate_scenario("prefix-heavy", seed=6, n_requests=25)
    p_torch, p_jax = tmp_path / "torch.jsonl", tmp_path / "jax.jsonl"
    save_trace(str(p_torch), reqs)
    jax_trace.save_trace(str(p_jax), _jax_twins(reqs))
    assert p_torch.read_text() == p_jax.read_text()
    for kw in ({}, {"qps": 2.0}, {"slo": SLOSpec(ttft=3.0, tpot=0.02)}):
        jkw = dict(kw)
        if "slo" in kw:
            from repro.core.request import SLOSpec as JSLOSpec

            jkw["slo"] = JSLOSpec(ttft=3.0, tpot=0.02)
        assert _states(load_trace(str(p_jax), **kw)) == _states(
            jax_trace.load_trace(str(p_torch), **jkw))


# ------------------------------------------------------------------ twins
def test_cost_model_matches_paper_calibration():
    for name, (pred, target) in check_calibration().items():
        assert pred == pytest.approx(target, rel=0.02), name


def test_all_requests_complete_and_metrics_consistent():
    res = run_kairos(generate_trace(TraceConfig(n_requests=120, qps=2.0, seed=7)))
    assert len(res.completed()) == 120
    for r in res.completed():
        assert r.n_generated == r.output_len == len(r.token_times)
        assert r.token_times == sorted(r.token_times)
    s = summarize(res)
    assert s["e2e"] <= min(s["ttft"], s["tpot"]) + 1e-9


def test_decode_fault_recovery_and_prefix_cache():
    reqs = generate_trace(TraceConfig(n_requests=80, qps=2.0, seed=11))
    res = run_kairos(reqs, fault_plan=FaultPlan(decode_failures=(10.0,), recovery_time=3.0))
    assert len(res.completed()) == 80 and sum(r.restarts for r in res.completed()) > 0
    base = run_kairos(reqs)
    cached = run_kairos(reqs, sim_cfg=SimConfig(prefix_cache_hit_frac=0.5))
    assert cached.prefill_busy < 0.7 * base.prefill_busy


def test_registry_names_and_unknown_or_pathless_scenarios():
    assert {"paper-longtail", "bursty", "diurnal", "multi-tenant", "heavy-head",
            "prefix-heavy", "flash-crowd", "replay"} <= set(available_scenarios())
    with pytest.raises(ValueError, match="paper-longtail"):
        make_scenario("no-such-scenario")
    with pytest.raises(ValueError, match="path"):
        make_scenario("replay")


def test_arrival_and_scenario_validation():
    with pytest.raises(ValueError):
        PoissonArrivals(qps=0.0)
    with pytest.raises(ValueError):
        SinusoidalArrivals(amplitude=1.5)
    with pytest.raises(ValueError):
        MarkovModulatedArrivals(mean_on=-1.0)
    with pytest.raises(ValueError, match="unknown SLO class"):
        Scenario(name="bad", tenants=(TenantSpec("t", slo_class="gold"),))


@pytest.mark.parametrize("line, match", [
    ("not json at all", "not valid JSON"),
    ('["a", "list"]', "JSON object"),
    ('{"arrival": 1.0, "output_len": 5}', "input_len"),
    ('{"input_len": "many", "output_len": 5}', "integer"),
    ('{"input_len": 12.9, "output_len": 5}', "integer"),
    ('{"input_len": 0, "output_len": 5}', "positive"),
    ('{"input_len": 4, "output_len": 2, "arrival": "noon"}', "number"),
])
def test_load_trace_names_the_malformed_line(tmp_path, line, match):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({"arrival": 0.0, "input_len": 4, "output_len": 2}) + "\n"
                 + line + "\n")
    with pytest.raises(ValueError, match=match) as exc:
        load_trace(str(p))
    assert ":2:" in str(exc.value)


def _done(rid, ttft_ok=True):
    r = Request(rid=rid, arrival=0.0, input_len=4, output_len=2, slo=SLOSpec(ttft=1.0, tpot=1.0))
    r.phase = Phase.DONE
    r.first_token_time = 0.5 if ttft_ok else 5.0
    r.token_times = [r.first_token_time, r.first_token_time + 0.1]
    r.n_generated = 2
    r.done_time = r.token_times[-1]
    return r


def _shed(rid, tenant="default"):
    r = Request(rid=rid, arrival=0.0, input_len=4, output_len=2, tenant=tenant)
    r.phase = Phase.FAILED
    return r


def test_shed_requests_are_misses_and_goodput_counts_met_tokens():
    att = attainment([_done(0), _done(1), _shed(2), _shed(3)])
    assert att.n == 4 and att.n_shed == 2 and att.ttft == att.e2e == 0.5
    assert attainment([_done(0), _shed(1)], done_only=True).e2e == 1.0
    by = attainment_by([_done(0), _shed(1, tenant="a")], "tenant")
    assert by["a"].e2e == 0.0 and by["default"].e2e == 1.0
    ok, late = _done(0), _done(1, ttft_ok=False)
    assert goodput([ok, late]) == pytest.approx(ok.n_generated / 5.1)
    assert goodput([_shed(2)]) == 0.0


def test_trace_and_pacer_properties():
    hypothesis = pytest.importorskip("hypothesis", reason="optional dep: hypothesis")
    st = hypothesis.strategies

    @hypothesis.given(st.integers(0, 10_000), st.floats(0.5, 10.0))
    @hypothesis.settings(max_examples=15, deadline=None)
    def trace_invariants(seed, qps):
        cfg = TraceConfig(n_requests=50, qps=qps, seed=seed)
        reqs = generate_trace(cfg)
        arr = [r.arrival for r in reqs]
        assert arr == sorted(arr)
        for r in reqs:
            assert cfg.min_input <= r.input_len <= cfg.max_input
            assert cfg.min_output <= r.output_len <= cfg.max_output
        assert 1 / (3 * qps) < np.diff(arr).mean() < 3 / qps

    times = st.lists(st.floats(0.0, 10.0).map(lambda x: round(x, 4)), min_size=1,
                     max_size=30).map(sorted)

    @hypothesis.given(times, st.floats(0.01, 0.2))
    @hypothesis.settings(max_examples=30, deadline=None)
    def pacer_properties(times, tpot):
        out = DeliveryPacer(mode="paced").delivery_times(times, times[0], tpot)
        assert all(d >= g for d, g in zip(out, times, strict=True))
        assert out == sorted(out)
        assert DeliveryPacer().delivery_times(times, times[0], tpot) == times
        for t_now in (times[0], times[-1] + 1.0):
            assert DeliveryPacer(mode="paced").banked(times, t_now, times[0], tpot) >= 0

    trace_invariants()
    pacer_properties()
