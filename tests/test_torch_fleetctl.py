"""The port's fleet controller (``repro_torch.serving.fleetctl``) on bridged
``llama3-8b-smoke`` f32 weights: the JAX package's ``FleetSession`` and the
port's, with a replica kill and ``queue-threshold`` scale-up on
ManualClocks, give identical tokens, token times, summaries (autoscale
decisions and recovery plans included) and event streams; the port's
``DisaggServer.reset_for_restart`` leaves a server that serves as a fresh
one; and torch twins of the reference's failover, autoscaler, windowed-SLO
and fault-planning invariants (tests/test_fleetctl.py,
tests/test_policies_registry.py, tests/test_fault_planning.py)."""
import asyncio

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.core.request import SLOSpec as JaxSLOSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs.export import chrome_trace as jax_chrome_trace  # noqa: E402
from repro.serving.clock import ManualClock as JaxManualClock  # noqa: E402
from repro.serving.engine import DisaggServer as JaxDisaggServer  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.fleetctl import FleetSession as JaxFleetSession  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lut import StepTimeLUT  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.dist.fault import FleetState, plan_recovery  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    Event,
    EventType,
    attainment_from_events,
    check_terminal_invariant,
    chrome_trace,
    windowed_slo,
)
from repro_torch.policies import (  # noqa: E402
    PolicySpec,
    available_autoscaler_policies,
    available_decode_policies,
    available_prefill_policies,
    make_autoscaler,
    make_decode,
    make_prefill,
)
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402
from repro_torch.serving.fleetctl import FleetSession  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402

ECFG = dict(max_slots=4, max_len=64, chunk_size=16)


@pytest.fixture(scope="module")
def both_models():
    """(jax_model, jax_params, torch_model, torch_params) with equal weights."""
    jcfg = jax_get_config("llama3-8b-smoke").replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, build_model(cfg), tp


def _server(both_models, **kw):
    _, _, model, params = both_models
    return DisaggServer(model, params, EngineConfig(**{**ECFG, **kw}),
                        clock=ManualClock(auto_step=1e-4), device="cpu")


def _jax_server(both_models):
    jm, jp, _, _ = both_models
    return JaxDisaggServer(jm, jp, JaxEngineConfig(**ECFG), clock=JaxManualClock(auto_step=1e-4))


def _crowd_pairs(n=24, input_len=40, output_len=4, gap=0.001, req_cls=Request,
                 slo_cls=SLOSpec):
    """A flash crowd of multi-chunk prefills arriving faster than one
    replica drains them, so the admission-queue gauge stands tall."""
    rng = np.random.default_rng(0)
    return [
        (req_cls(rid=i, arrival=gap * i, input_len=input_len, output_len=output_len,
                 slo=slo_cls(ttft=0.015, tpot=1.0)),
         list(map(int, rng.integers(2, 256, input_len))))
        for i in range(n)
    ]


async def _replay_collecting(fleet, pairs):
    """Replay through the fleet, returning what each client received."""
    async with fleet:
        handles = [await fleet.submit(r, p, at=r.arrival) for r, p in pairs]
        results = await asyncio.gather(*(h.result() for h in handles))
    return {h.rid: res for h, res in zip(handles, results, strict=True)}


# ------------------------------------------------------ against the JAX package
def test_fleet_with_kill_and_scale_up_matches_jax_fleet(both_models):
    """Two replicas, replica 0 killed at t=0.01 (its in-flight requests
    restored on survivors), queue-threshold scale-up through a
    server_factory: the JAX FleetSession and the port's deliver identical
    client streams, tokens, token_times, phases, summary() (autoscale
    decisions and recovery plans included) and event streams."""
    kw = dict(policy="least-queued", autoscaler="queue-threshold", n_min=1, n_max=3,
              autoscale_interval=0.005, slo_window=0.005, kill_schedule=[(0.01, 0)])
    jpairs = _crowd_pairs(req_cls=JaxRequest, slo_cls=JaxSLOSpec)
    tpairs = _crowd_pairs()
    jfleet = JaxFleetSession([_jax_server(both_models) for _ in range(2)],
                             server_factory=lambda: _jax_server(both_models), **kw)
    tfleet = FleetSession([_server(both_models) for _ in range(2)],
                          server_factory=lambda: _server(both_models), **kw)
    jgot = asyncio.run(_replay_collecting(jfleet, jpairs))
    tgot = asyncio.run(_replay_collecting(tfleet, tpairs))
    assert tgot == jgot
    assert tfleet.outputs == jfleet.outputs
    for (jr, _), (tr, _) in zip(jpairs, tpairs, strict=True):
        assert tr.phase.value == jr.phase.value == "done"
        assert tr.token_times == jr.token_times, tr.rid
        assert tr.restarts == jr.restarts
        assert tgot[tr.rid] == tfleet.outputs[tr.rid]
    ts = tfleet.summary()
    assert ts == jfleet.summary()
    fleet = ts["fleet"]
    assert fleet["kills"] == 1 and fleet["restored"] >= 1 and fleet["scale_ups"] >= 1
    assert fleet["recoveries"][0]["steps"] and fleet["decisions"]
    assert [e.as_dict() for e in tfleet.trace.events] == [
        e.as_dict() for e in jfleet.trace.events
    ]
    tdoc, jdoc = chrome_trace(tfleet.trace.events), jax_chrome_trace(jfleet.trace.events)
    assert tdoc["traceEvents"] == jdoc["traceEvents"]


def test_scaled_up_replica_joins_the_fleet_clock_on_wall_clocks(both_models):
    """ROADMAP C4: on wall clocks a replica built by scale-up reads the
    fleet's time, not its own age. The reference zeroes the newcomer's
    clock at start, so its stepper holds each routed arrival back until its
    clock reaches the arrival's fleet time (pinned below as recorded)."""
    from repro.serving.clock import MonotonicClock as JaxMonotonicClock
    from repro_torch.serving.clock import MonotonicClock

    jm, jp, model, params = both_models

    def clocks_after_scale_up(fleet_cls, make):
        async def run():
            fleet = fleet_cls([make()], autoscale_interval=0.0, server_factory=make)
            async with fleet:
                await asyncio.sleep(0.2)
                assert await fleet._scale_up(0.2)
                return [rep.frontend.session.server.peek_now() for rep in fleet.replicas]

        return asyncio.run(run())

    t_old, t_new = clocks_after_scale_up(
        FleetSession, lambda: DisaggServer(model, params, EngineConfig(**ECFG),
                                           clock=MonotonicClock(), device="cpu"))
    assert t_new >= 0.2 and abs(t_new - t_old) < 0.05
    j_old, j_new = clocks_after_scale_up(
        JaxFleetSession, lambda: JaxDisaggServer(jm, jp, JaxEngineConfig(**ECFG),
                                                 clock=JaxMonotonicClock()))
    assert j_old >= 0.2 and j_new < 0.1  # the reference's fault, as recorded


# ------------------------------------------------------------- restart
@pytest.mark.parametrize("page_size", [None, 16])
def test_reset_for_restart_serves_as_a_fresh_server(both_models, page_size):
    """A server that served, had a request cut off mid-flight and was reset
    serves the next requests exactly as a freshly built one: same tokens,
    same token_times (cache, allocator, schedulers, generator and clock
    all rebuilt)."""
    def pairs():
        rng = np.random.default_rng(9)
        return [(Request(rid=i, arrival=0.002 * i, input_len=n, output_len=5,
                         slo=SLOSpec(ttft=120.0, tpot=10.0)),
                 list(map(int, rng.integers(2, 256, n)))) for i, n in enumerate((9, 30, 17))]

    used = _server(both_models, page_size=page_size)
    used.serve(pairs())
    sess = ServeSession(used)  # a second run, cut off mid-flight
    for r, p in pairs():
        sess.submit(r, p)
    for _ in range(4):
        sess.step()
    assert sess.has_work
    used.reset_for_restart()
    assert used.decode.alloc.live_tokens == {}
    if page_size:
        assert used.decode.pages.free_pages == used.decode.pages.n_pages
    a, b = pairs(), pairs()
    assert used.serve(a) == _server(both_models, page_size=page_size).serve(b)
    for (ra, _), (rb, _) in zip(a, b, strict=True):
        assert ra.token_times == rb.token_times


# ------------------------------------------------ twins of tests/test_fleetctl.py
def test_kill_mid_decode_restores_on_survivors(both_models):
    """One of three replicas dies mid-decode under a flash crowd; its
    in-flight requests finish on survivors with the token streams spliced
    exactly once, and every rid ends with exactly one terminal event."""
    from repro.workloads.scenarios import make_scenario

    scen_reqs = make_scenario("flash-crowd", n_requests=12).generate(seed=3)
    rng = np.random.default_rng(3)
    max_in = max(r.input_len for r in scen_reqs)
    pairs = []
    for r in scen_reqs:
        n_in = 2 + round(10 * r.input_len / max_in)
        pairs.append((Request(rid=r.rid, arrival=r.arrival * 1e-4, input_len=n_in,
                              output_len=6, slo=SLOSpec(ttft=120.0, tpot=10.0),
                              tenant=r.tenant, slo_class=r.slo_class),
                      list(map(int, rng.integers(2, 256, n_in)))))

    async def _run():
        fleet = FleetSession([_server(both_models) for _ in range(3)], policy="round-robin",
                             autoscaler="static", autoscale_interval=0.0)
        async with fleet:
            handles = [await fleet.submit(req, p, at=req.arrival) for req, p in pairs]

            async def killer():
                while True:
                    sess = fleet.replicas[1].frontend.session
                    if any(lr.req.n_generated >= 1 for lr in sess.active):
                        return await fleet.kill_replica(1)
                    await asyncio.sleep(0)

            results = {}

            async def consume(h):
                results[h.rid] = await h.result()

            record, *_ = await asyncio.gather(killer(), *(consume(h) for h in handles))
        return fleet, record, results

    fleet, record, results = asyncio.run(_run())
    assert record["restored"], "kill landed on an idle replica (vacuous test)"
    assert [s[0] for s in record["steps"][:2]] == ["drain", "checkpoint"]
    assert record["steps"][-1][0] == "restore"
    assert record["mesh"]["shape"]
    assert record["snapshot"]["slots_live"] >= 1
    outs = fleet.outputs
    for req, _prompt in pairs:
        assert req.phase is Phase.DONE, (req.rid, req.phase)
        assert results[req.rid] == outs[req.rid], req.rid
        assert len(results[req.rid]) == req.output_len, req.rid
    terminals = check_terminal_invariant(fleet.trace.events)
    assert all(len(t) == 1 for t in terminals.values()), terminals
    restores = [e for e in fleet.trace.events if e.type is EventType.RESTORE]
    assert {e.rid for e in restores} == set(record["restored"])
    assert all(e.data["src"] == 1 and e.data["dst"] != 1 for e in restores)
    s = fleet.summary()
    assert s["fleet"]["kills"] == 1
    assert s["fleet"]["restored"] == len(record["restored"])
    assert s["submitted"] == s["accepted"] == s["completed"] == len(pairs)
    # the dead replica was rebuilt empty by reset_for_restart
    dead = fleet.replicas[1].frontend.session.server
    assert dead.decode.alloc.live_tokens == {}


def test_kill_refuses_last_live_replica(both_models):
    async def _run():
        fleet = FleetSession([_server(both_models)], autoscale_interval=0.0)
        async with fleet:
            with pytest.raises(RuntimeError, match="last live replica"):
                await fleet.kill_replica(0)

    asyncio.run(_run())


def test_scale_up_requires_factory(both_models):
    async def _run():
        fleet = FleetSession([_server(both_models)], autoscale_interval=0.0)
        async with fleet:
            assert not await fleet._scale_up(0.0)
        assert fleet.summary()["fleet"]["scale_ups"] == 0

    asyncio.run(_run())


def _ev(etype, t, rid=-1, **data):
    return Event(type=etype, t=t, rid=rid, data=data)


def _lifecycle(rid, t0, terminal=EventType.DONE, n_tokens=2, tok_dt=0.01,
               slo_ttft=1.0, slo_tpot=1.0):
    evs = [
        _ev(EventType.SUBMIT, t0, rid, arrival=t0, input_len=4,
            output_len=n_tokens, slo_ttft=slo_ttft, slo_tpot=slo_tpot),
        _ev(EventType.ADMIT, t0, rid),
        _ev(EventType.PREFILL_END, t0 + tok_dt / 2, rid),
    ]
    t = t0
    for _ in range(n_tokens):
        t += tok_dt
        evs.append(_ev(EventType.TOKEN, t, rid))
    evs.append(_ev(terminal, t + tok_dt, rid))
    return evs


def test_windowed_slo_empty_stream():
    assert windowed_slo([], 0.5) == dict(window=0.5, n_windows=0, windows=[])


def test_windowed_slo_rejects_nonpositive_window():
    with pytest.raises(ValueError, match="positive"):
        windowed_slo([], 0.0)
    with pytest.raises(ValueError, match="positive"):
        windowed_slo(_lifecycle(0, 0.0), -1.0)


def test_windowed_slo_boundary_events():
    evs = _lifecycle(0, 0.0, n_tokens=1, tok_dt=0.25)  # terminal at t=0.5
    out = windowed_slo(evs, 0.5)
    assert out["n_windows"] == 2
    assert [w["done"] for w in out["windows"]] == [0, 1]
    assert out["windows"][1]["t0"] == 0.5
    assert out["windows"][0]["submitted"] == 1


def test_windowed_slo_per_window_counts_sum_to_attainment():
    """Windowed counts partition the run: per-window sums reproduce
    `attainment_from_events` exactly, for any seeded stream; and the port's
    windows equal the JAX package's on the same stream."""
    from repro.obs.events import Event as JaxEvent
    from repro.obs.slo import windowed_slo as jax_windowed_slo

    rng = np.random.default_rng(7)
    for _trial in range(5):
        evs = []
        n = int(rng.integers(5, 40))
        for rid in range(n):
            t0 = float(rng.uniform(0.0, 3.0))
            terminal = [EventType.DONE, EventType.SHED, EventType.CANCEL][
                int(rng.integers(0, 3)) if rid % 2 else 0
            ]
            evs.extend(_lifecycle(rid, t0, terminal=terminal,
                                  n_tokens=int(rng.integers(1, 6)),
                                  tok_dt=float(rng.uniform(0.005, 0.2)),
                                  slo_ttft=float(rng.uniform(0.01, 0.5)),
                                  slo_tpot=float(rng.uniform(0.01, 0.3))))
        att = attainment_from_events(evs)
        window = float(rng.uniform(0.1, 1.0))
        out = windowed_slo(evs, window)
        wins = out["windows"]
        assert sum(w["done"] for w in wins) + sum(w["shed"] for w in wins) == att["n"]
        assert sum(w["cancelled"] for w in wins) == att["n_cancelled"]
        assert sum(w["submitted"] for w in wins) == n
        for key in ("ttft", "tpot", "e2e"):
            hits = sum(w[key] * (w["done"] + w["shed"]) for w in wins)
            assert hits == pytest.approx(att[key] * att["n"])
        assert out == jax_windowed_slo([JaxEvent.from_dict(e.as_dict()) for e in evs], window)


# --------------------------------------- twins of tests/test_policies_registry.py
def test_autoscaler_side_constructs_and_decides():
    empty = dict(window=0.5, n_windows=0, windows=[])
    for name in available_autoscaler_policies():
        pol = make_autoscaler(name)
        assert pol.name == name
        assert pol.decide(empty, 2, 1, 4) == 2
    qt = make_autoscaler(PolicySpec("queue-threshold", {"high": 2}))
    spike = dict(window=0.5, n_windows=1, windows=[
        dict(queue_depth_max=3, queue_depth_last=3, done=0, shed=0, e2e=0.0)
    ])
    assert qt.decide(spike, 1, 1, 4) == 2


def test_unknown_name_raises_with_known_names():
    lut = StepTimeLUT(analytic=lambda b, s: 0.005 + 0.0002 * b + 2.4e-7 * s)
    with pytest.raises(ValueError) as ei:
        make_prefill("no-such-policy")
    assert all(name in str(ei.value) for name in available_prefill_policies())
    with pytest.raises(ValueError) as ei:
        make_decode("no-such-policy", lut)
    assert all(name in str(ei.value) for name in available_decode_policies())
    with pytest.raises(ValueError) as ei:
        make_autoscaler("no-such-policy")
    assert all(name in str(ei.value) for name in available_autoscaler_policies())


# ------------------------------------------ twin of tests/test_fault_planning.py
def test_recovery_plan_narrative():
    from repro.dist.fault import FleetState as JaxFleetState
    from repro.dist.fault import plan_recovery as jax_plan_recovery

    rec = plan_recovery(FleetState(pods=(256, 120)))
    steps = rec.describe()
    assert any("shed pods" in s for s in steps)
    assert any("reset_for_restart" in s for s in steps)
    assert any("checkpoint" in s for s in steps)
    assert steps == jax_plan_recovery(JaxFleetState(pods=(256, 120))).describe()
