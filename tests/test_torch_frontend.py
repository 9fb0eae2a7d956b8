"""The port's async streaming frontend (``repro_torch.serving.frontend``) on
bridged ``llama3-8b-smoke`` f32 weights: the JAX package's
``AsyncServeSession`` and the port's, on a ManualClock with the same
requests, give identical tokens, token times, summaries and event streams;
and torch twins of the reference's frontend invariants
(tests/test_async_frontend.py) and trace exporters (tests/test_obs.py)."""
import asyncio
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.core.request import SLOSpec as JaxSLOSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs.events import TraceRecorder as JaxTraceRecorder  # noqa: E402
from repro.serving.clock import ManualClock as JaxManualClock  # noqa: E402
from repro.serving.engine import DisaggServer as JaxDisaggServer  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.frontend import AsyncServeSession as JaxAsyncServeSession  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    EventType,
    TraceRecorder,
    chrome_trace,
    trace_cell_block,
    windowed_slo,
    write_trace,
)
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402
from repro_torch.serving.frontend import AsyncServeSession  # noqa: E402

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


def _jax_server(both_models, **kw):
    jm, jp, _, _ = both_models
    return JaxDisaggServer(jm, jp, JaxEngineConfig(**{**ECFG, **kw}),
                           clock=JaxManualClock(auto_step=1e-4))


def _requests(n=4, max_out=4, seed=0, arrival_gap=0.0, req_cls=Request, slo_cls=SLOSpec):
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(2, 256, int(rng.integers(4, 14)))))
               for _ in range(n)]
    return [
        (req_cls(rid=i, arrival=arrival_gap * i, input_len=len(p), output_len=max_out,
                 slo=slo_cls(ttft=120.0, tpot=10.0)), p)
        for i, p in enumerate(prompts)
    ]


def _events(trace):
    return [e.as_dict() for e in trace.events]


# ------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("prefill_policy,decode_policy",
                         [("kairos-urgency", "kairos-slack"), ("fcfs", "continuous")])
def test_async_frontend_matches_jax_frontend(both_models, prefill_policy, decode_policy):
    """The same replay through the JAX AsyncServeSession and the port's, on
    ManualClock(auto_step=1e-4): identical tokens, token_times, terminal
    phases, summary() and event streams (every field, so (type, t) too)."""
    kw = dict(prefill_policy=prefill_policy, decode_policy=decode_policy)
    jpairs = _requests(n=6, max_out=5, seed=2, arrival_gap=0.004,
                       req_cls=JaxRequest, slo_cls=JaxSLOSpec)
    tpairs = _requests(n=6, max_out=5, seed=2, arrival_gap=0.004)

    async def run(frontend, pairs):
        async with frontend:
            return await frontend.replay(pairs, clients=3)

    jtrace, ttrace = JaxTraceRecorder(), TraceRecorder()
    jfe = JaxAsyncServeSession(_jax_server(both_models, **kw), trace=jtrace)
    tfe = AsyncServeSession(_server(both_models, **kw), trace=ttrace)
    jout = asyncio.run(run(jfe, jpairs))
    tout = asyncio.run(run(tfe, tpairs))
    assert tout == jout
    for (jr, _), (tr, _) in zip(jpairs, tpairs, strict=True):
        assert tr.phase.value == jr.phase.value == "done"
        assert tr.token_times == jr.token_times, tr.rid
    assert tfe.summary() == jfe.summary()
    assert _events(ttrace) == _events(jtrace)


# ------------------------------------------- twins of tests/test_async_frontend.py
def test_async_sync_parity_on_manual_clock(both_models):
    """On the same trace and ManualClock, the async frontend reproduces
    ServeSession.run()'s outputs and per-request token times bit for bit."""
    reqs_sync = _requests(n=5, max_out=4, seed=2, arrival_gap=0.01)
    reqs_async = copy.deepcopy(reqs_sync)
    outs_sync = _server(both_models).serve(reqs_sync)
    server_b = _server(both_models)

    async def run_async():
        frontend = AsyncServeSession(server_b)
        async with frontend:
            return await frontend.replay(reqs_async, clients=3)

    outs_async = asyncio.run(run_async())
    assert outs_sync == outs_async
    for (rs, _), (ra, _) in zip(reqs_sync, reqs_async, strict=True):
        assert rs.phase == ra.phase == Phase.DONE
        assert rs.ttft() == ra.ttft()
        assert rs.mean_tpot() == ra.mean_tpot()
        assert rs.token_times == ra.token_times


def test_streaming_token_order_and_ttft_timestamps(both_models):
    """Tokens arrive through handle.stream() in generation order, and the
    first streamed token's timestamp is the request's TTFT anchor."""
    server = _server(both_models)
    pairs = _requests(n=3, max_out=3, seed=1)

    async def run():
        streamed = {}

        async def consume(h):
            async for tok in h.stream():
                streamed.setdefault(h.rid, []).append(tok)

        frontend = AsyncServeSession(server)
        async with frontend:
            handles = [await frontend.submit(r, p) for r, p in pairs]
            assert all([await h.admitted() for h in handles])
            await asyncio.gather(*(consume(h) for h in handles))
        return streamed, frontend

    streamed, frontend = asyncio.run(run())
    assert streamed == frontend.session.outputs
    for r, _ in pairs:
        assert r.phase == Phase.DONE
        assert r.first_token_time == r.token_times[0]
        assert r.ttft() == r.first_token_time - r.arrival


def test_backpressure_shed_cancels_slow_consumer(both_models):
    """A consumer that never drains its 1-token buffer gets shed: the
    request is cancelled, counted in backpressure_shed, and its decode slot
    is reclaimed."""
    server = _server(both_models)
    (req, prompt), = _requests(n=1, max_out=5, seed=3)

    async def run():
        frontend = AsyncServeSession(server, stream_buffer=1, backpressure="shed")
        async with frontend:
            handle = await frontend.submit(req, prompt)
            assert await handle.admitted()
        return frontend, handle

    frontend, handle = asyncio.run(run())
    assert req.phase == Phase.CANCELLED
    assert handle.cancel_reason == "backpressure"
    m = frontend.metrics
    assert m.backpressure_shed == 1
    assert m.cancelled == 1 and m.cancelled_rids == [req.rid]
    assert m.rejected == 0
    assert frontend.session.active == [] and frontend.session.queue == []
    assert server.decode.alloc.live_tokens == {}


def test_midstream_cancel_reclaims_slot_and_queue(both_models):
    """Breaking out of handle.stream() mid-generation is a client
    disconnect: the request ends CANCELLED, its slot and queue entry are
    reclaimed, and the other stream runs to completion undisturbed."""
    server = _server(both_models)
    (r0, p0), (r1, p1) = _requests(n=2, max_out=6, seed=5)

    async def run():
        frontend = AsyncServeSession(server)
        async with frontend:
            h0 = await frontend.submit(r0, p0)
            h1 = await frontend.submit(r1, p1)

            async def disconnect_after_first(h):
                async for _ in h.stream():
                    break

            async def drain(h):
                async for _ in h.stream():
                    pass

            await asyncio.gather(disconnect_after_first(h0), drain(h1))
        return frontend

    frontend = asyncio.run(run())
    assert r0.phase == Phase.CANCELLED and r1.phase == Phase.DONE
    assert r0.n_generated >= 1
    assert len(frontend.session.outputs[r1.rid]) == r1.n_generated
    assert frontend.session.queue == []
    assert frontend.session.waiting_adm == []
    assert frontend.session.active == []
    assert server.decode.alloc.live_tokens == {}
    s = frontend.summary()
    assert s["cancelled"] == 1 and s["cancelled_rids"] == [r0.rid]
    assert s["completed"] == 1
    assert {d["rid"]: d for d in s["requests"]}[r0.rid]["phase"] == "cancelled"


def test_stepper_crash_surfaces_instead_of_hanging(both_models):
    """An engine exception mid-run unblocks consumers (EOS) and re-raises
    out of drain()/async-with; the frontend never deadlocks."""
    server = _server(both_models)
    (req, prompt), = _requests(n=1, max_out=4, seed=10)

    def boom(*a, **kw):
        raise RuntimeError("engine exploded")

    async def run():
        frontend = AsyncServeSession(server)
        frontend.session.step = boom
        handle = None
        with pytest.raises(RuntimeError, match="engine exploded"):
            async with frontend:
                handle = await frontend.submit(req, prompt)
                return [tok async for tok in handle.stream()], handle
        return [], handle

    out, handle = asyncio.run(asyncio.wait_for(run(), timeout=30))
    assert out == []
    assert handle.cancel_reason in ("client", "error")


def test_frontend_needs_a_card_unless_asked_for_the_cpu(both_models):
    """No fallback: the server under the frontend raises without a card
    unless it is given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, model, params = both_models
    with pytest.raises(RuntimeError, match="cuda"):
        AsyncServeSession(DisaggServer(model, params, EngineConfig(**ECFG)))


# ------------------------------------------------ twins of tests/test_obs.py
def _stream() -> TraceRecorder:
    """One hand-built request lifecycle across a prefill and a decode pool."""
    tr = TraceRecorder()
    tr.emit(EventType.SUBMIT, 0.0, rid=0, tenant="a", pool="p0", arrival=0.0,
            input_len=4, output_len=2, slo_ttft=1.0, slo_tpot=0.5,
            slo_class="standard")
    tr.emit(EventType.ADMIT, 0.0, rid=0, tenant="a", pool="p0", queue_depth=1)
    tr.emit(EventType.PREFILL_START, 0.1, rid=0, pool="p0", take=4)
    tr.emit(EventType.PREFILL_END, 0.2, rid=0, pool="p0", queue_depth=0)
    tr.emit(EventType.HANDOFF_QUEUED, 0.2, rid=0, pool="p0")
    tr.emit(EventType.HANDOFF_START, 0.2, rid=0, pool="p0", ready_at=0.25)
    tr.emit(EventType.TOKEN, 0.2, rid=0, pool="p0")
    tr.emit(EventType.HANDOFF_ATTACH, 0.25, rid=0, pool="p1", slot=0)
    tr.emit(EventType.DECODE_STEP, 0.3, pool="p1", batch=1, step_time=0.05,
            tpot_budget=0.5)
    tr.emit(EventType.TOKEN, 0.3, rid=0, tenant="a", pool="p1", slot=0)
    tr.emit(EventType.DONE, 0.3, rid=0, tenant="a", pool="p1", slot=0,
            n_generated=2)
    return tr


def test_chrome_trace_shape():
    doc = chrome_trace(_stream().events)
    assert set(doc) >= {"traceEvents", "displayTimeUnit", "otherData"}
    evs = doc["traceEvents"]
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"p0", "p1"} <= names
    assert {"X", "s", "f"} <= {e["ph"] for e in evs}
    flow_ids = [e["id"] for e in evs if e["ph"] in ("s", "f")]
    assert flow_ids and all(i != 0 for i in flow_ids)
    tracks = {}
    for e in evs:
        if e["ph"] == "M":
            continue
        tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e["ts"])
    for ts in tracks.values():
        assert all(a <= b for a, b in zip(ts, ts[1:], strict=False))


def test_write_trace_dispatches_on_suffix(tmp_path):
    tr = _stream()
    assert write_trace(tr.events, str(tmp_path / "t.jsonl")) == "jsonl"
    assert write_trace(tr.events, str(tmp_path / "t.json")) == "chrome"


def test_windowed_slo_rejects_bad_window():
    with pytest.raises(ValueError):
        windowed_slo(_stream().events, 0.0)


def test_windowed_slo_buckets_terminal_events():
    out = windowed_slo(_stream().events, 0.25)
    assert out["window"] == 0.25 and out["n_windows"] == 2
    assert sum(w["done"] for w in out["windows"]) == 1
    assert sum(w["submitted"] for w in out["windows"]) == 1
    assert sum(w["tokens"] for w in out["windows"]) == 2
    assert out["windows"][-1]["inflight_last"] == 0


def test_trace_cell_block_summary():
    block = trace_cell_block(_stream().events, slo_window=0.25)
    assert block["events"] == 11 and block["requests"] == 1
    assert block["multi_terminal"] == 0
    assert block["attainment"]["n"] == 1
    assert block["slo"]["n_windows"] == 2
    assert "slo" not in trace_cell_block(_stream().events)
