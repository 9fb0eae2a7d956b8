"""Spans inside the port's engine calls (``repro_torch.serving.probe``), on
the CPU: recording them moves nothing on a ManualClock; the decode phases
tile each step; ``prefill.chunk`` carries each chunk; under a CPU
``torch.profiler`` the ``decode.*``, ``prefill.chunk`` and ``moe.*`` ranges
nest in order, and without one no range is opened. The on-card readings
(``device_s``) are held by ``tests/test_torch_cuda.py``."""
import contextlib
from dataclasses import dataclass
from itertools import accumulate

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs.events import EventType, TraceRecorder  # noqa: E402
from repro_torch.obs.export import chrome_trace, write_trace  # noqa: E402
from repro_torch.serving import probe as probe_mod  # noqa: E402
from repro_torch.serving import session as session_mod  # noqa: E402
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402

ECFG = dict(max_slots=4, max_len=64, chunk_size=16)
DECODE = ("decode.gather", "decode.forward", "decode.scatter", "decode.sample", "decode.wait")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(scope="module")
def dense():
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(0, device="cpu")


@pytest.fixture(scope="module")
def moe():
    cfg = get_config("phi3.5-moe-42b-a6.6b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    return model, model.init(0, device="cpu")


@dataclass
class _PeekTicks(ManualClock):
    """A ManualClock whose every ``peek()`` advances it by ``tick``."""

    tick: float = 0.0

    def peek(self) -> float:
        self.t += self.tick
        return self.t


def _pairs(n=5, out=5, seed=0):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(4, 41, n)]
    return [(Request(rid=i, arrival=0.002 * i, input_len=k, output_len=out,
                     slo=SLOSpec(ttft=60.0, tpot=5.0)),
             list(map(int, rng.integers(2, 200, k)))) for i, k in enumerate(lens)]


def _serve(mp, clock, trace, **kw):
    model, params = mp
    srv = DisaggServer(model, params, EngineConfig(**{**ECFG, **kw}), clock=clock, device="cpu")
    sess = ServeSession(srv, trace=trace)
    pairs = _pairs()
    out = sess.run(pairs)
    return out, [r.token_times for r, _ in pairs], sess.summary(), srv


def _events(trace):
    return [e.as_dict() for e in trace.events]


def _steps(trace):
    """The decode spans grouped by step, in order."""
    dec = [s for s in trace.spans if s.name.startswith("decode.")]
    assert len(dec) % len(DECODE) == 0
    return [dec[i:i + len(DECODE)] for i in range(0, len(dec), len(DECODE))]


@pytest.mark.parametrize("page_size", [None, 16])
def test_spans_leave_a_manual_clock_run_bit_identical(dense, monkeypatch, page_size):
    """ManualClock(auto_step=1e-4): tokens, token times, the summary and the
    events are the same with spans recorded, with the recorder but no
    probe lent, and (events aside) with no recorder."""
    on = TraceRecorder()
    out_on, times_on, summ_on, srv = _serve(dense, ManualClock(auto_step=1e-4), on,
                                            page_size=page_size)
    assert on.spans and srv.decode.probe is None and srv.prefill.probe is None
    out_none, times_none, summ_none, _ = _serve(dense, ManualClock(auto_step=1e-4), None,
                                                page_size=page_size)
    monkeypatch.setattr(session_mod, "lent", lambda probes: contextlib.nullcontext())
    off = TraceRecorder()
    out_off, times_off, summ_off, _ = _serve(dense, ManualClock(auto_step=1e-4), off,
                                             page_size=page_size)
    assert off.spans == [] and off.events
    assert out_on == out_off == out_none
    assert times_on == times_off == times_none
    assert summ_on == summ_off == summ_none
    assert _events(on) == _events(off)


@pytest.mark.parametrize("page_size", [None, 16])
def test_decode_phases_tile_each_step(dense, page_size):
    """On a clock whose every peek advances by a tick, each step's five
    decode spans come in order, each starting where the last ended, and
    together last the DECODE_STEP's step_time less one tick (the session's
    own read before the step); nothing has a device time on the CPU."""
    tick = 1e-3
    trace = TraceRecorder()
    _serve(dense, _PeekTicks(tick=tick), trace, page_size=page_size)
    steps = [e for e in trace.events if e.type is EventType.DECODE_STEP]
    groups = _steps(trace)
    assert len(groups) == len(steps) > 0
    for ev, g in zip(steps, groups, strict=True):
        assert tuple(s.name for s in g) == DECODE
        for a, b in zip(g, g[1:], strict=False):
            assert a.t1 == b.t0
        assert all(s.t1 - s.t0 == pytest.approx(tick) for s in g)
        assert g[-1].t1 - g[0].t0 == pytest.approx(ev.data["step_time"] - tick, abs=1e-12)
        assert all(s.data == {} for s in g)
    assert all(s.device_s is None for s in trace.spans)
    assert {s.pool for s in trace.spans} == {"engine:0"}


def test_prefill_chunk_spans_carry_each_chunk(dense):
    """Each request's chunks, in order: starts at 0 and at each earlier
    chunk's end, takes summing to the prompt, the first take the one its
    PREFILL_START names; each span lasts from its first peek to its last."""
    trace = TraceRecorder()
    _serve(dense, _PeekTicks(tick=1e-3), trace)
    chunks = [s for s in trace.spans if s.name == "prefill.chunk"]
    first = {e.rid: e.data["take"] for e in trace.events if e.type is EventType.PREFILL_START}
    lens = {r.rid: r.input_len for r, _ in _pairs()}
    assert set(first) == set(lens)
    for rid, n in lens.items():
        mine = [s.data for s in chunks if s.data["rid"] == rid]
        takes = [c["take"] for c in mine]
        assert [c["start"] for c in mine] == list(accumulate(takes, initial=0))[:-1]
        assert sum(takes) == n
        assert all(0 < c["take"] <= ECFG["chunk_size"] for c in mine)
        assert mine[0]["take"] == first[rid]
    assert all(s.t1 - s.t0 == pytest.approx(1e-3) and s.device_s is None for s in chunks)


def _ranges(prof, names):
    return sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in names), key=lambda r: (r[0], -r[1]))


def test_profiler_ranges_nest_in_order(moe, monkeypatch):
    """Under a CPU profiler: five decode ranges a step in order, one
    prefill.chunk a chunk, and four moe.* ranges in order for every call of
    the MoE layer, each inside a decode.forward or a prefill.chunk."""
    calls = []
    local = moe_mod._moe_local
    monkeypatch.setattr(moe_mod, "_moe_local", lambda *a: calls.append(1) or local(*a))
    trace = TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(moe, ManualClock(auto_step=1e-4), trace, page_size=16)
    n_steps = sum(e.type is EventType.DECODE_STEP for e in trace.events)
    n_chunks = sum(s.name == "prefill.chunk" for s in trace.spans)
    dec = _ranges(prof, DECODE)
    assert [r[2] for r in dec] == list(DECODE) * n_steps
    outer = _ranges(prof, ("decode.forward", "prefill.chunk"))
    assert len(outer) == n_steps + n_chunks
    moes = _ranges(prof, MOE)
    assert len(calls) > 0
    assert [r[2] for r in moes] == list(MOE) * len(calls)
    for a, b, _ in moes:
        assert any(x <= a and b <= y for x, y, _ in outer)
    # the calls of the layer inside one forward come layer after layer
    per_forward = [sum(x <= a and b <= y for a, b, _ in moes) for x, y, _ in outer]
    assert per_forward == [4 * moe[0].cfg.num_layers] * len(outer)


def test_no_range_is_opened_without_a_profiler(moe, monkeypatch):
    """The probe and the MoE layer open ranges only while a profiler runs:
    with ``record_function`` replaced by a counter, a traced serve opens
    none; the same serve under a profiler opens one per phase."""
    opened = []

    class _Counting(contextlib.nullcontext):
        def __init__(self, name):
            opened.append(name)
            super().__init__()

    monkeypatch.setattr(probe_mod, "record_function", _Counting)
    monkeypatch.setattr(moe_mod, "record_function", _Counting)
    trace = TraceRecorder()
    _serve(moe, ManualClock(auto_step=1e-4), trace)
    assert trace.spans and opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(moe, ManualClock(auto_step=1e-4), TraceRecorder())
    assert set(opened) == {*DECODE, "prefill.chunk", *MOE}


def test_a_step_that_raises_closes_its_range_and_hands_in_nothing(dense, monkeypatch):
    """Under a profiler, a decode forward that raises on the third step:
    the error reaches the caller, the engines give the probe back, the
    failing step's open ``decode.forward`` range is closed by the time the
    error reaches the caller, and its phases are not recorded."""
    from repro_torch.serving import engine as engine_mod

    calls = []
    forward = engine_mod.decode_step

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return forward(*a, **kw)

    monkeypatch.setattr(engine_mod, "decode_step", failing)
    trace = TraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="planted"):
            _serve(dense, ManualClock(auto_step=1e-4), trace)
        with record_function("caught"):
            pass
    forwards = _ranges(prof, ("decode.forward",))
    assert [r[2] for r in forwards] == ["decode.forward"] * 3
    assert forwards[-1][1] <= _ranges(prof, ("caught",))[0][0]
    assert [s.name for s in trace.spans if s.name.startswith("decode.")] == list(DECODE) * 2


def test_the_readings_lie_inside_the_last_span():
    """`Phases.end` hands in the closed phases before its last clock read,
    so the probe's own work is inside the call's last span."""
    log = []

    class _Srv:
        device = torch.device("cpu")

        def peek_now(self):
            log.append("peek")
            return float(len(log))

    class _Log(TraceRecorder):
        def span(self, name, *a, **kw):
            log.append(name)
            super().span(name, *a, **kw)

    ph = probe_mod.Probe(_Srv(), _Log(), "engine:0").phases()
    for name in DECODE:
        ph.next(name)
    ph.end()
    assert log == ["peek"] * 5 + list(DECODE[:-1]) + ["peek", "decode.wait"]


def test_recorder_clear_empties_events_and_spans():
    tr = TraceRecorder()
    tr.emit(EventType.SUBMIT, 0.0, rid=1)
    tr.span("decode.gather", 0.0, 1.0, device_s=0.5, pool="engine:0", batch=2)
    assert len(tr) == 1 and tr.spans[0].data == {"batch": 2} and tr.spans[0].device_s == 0.5
    tr.clear()
    assert tr.events == [] and tr.spans == []


def test_the_chrome_trace_puts_each_pools_spans_on_its_engine_thread(dense, tmp_path):
    """`chrome_trace(events, spans)`: the spans become slices, in order, on an
    ``engine`` thread of their pool's process, their ``data`` and device
    time as args; without spans the document is the events' alone; a
    ``.jsonl`` trace keeps the events only."""
    trace = TraceRecorder()
    _serve(dense, _PeekTicks(tick=1e-3), trace)
    plain = chrome_trace(trace.events)
    doc = chrome_trace(trace.events, trace.spans)
    assert "spans" not in plain["otherData"] and doc["otherData"]["spans"] == len(trace.spans)
    evs = doc["traceEvents"]
    pid = next(e["pid"] for e in evs if e["ph"] == "M" and e["name"] == "process_name"
               and e["args"]["name"] == "engine:0")
    tid = next(e["tid"] for e in evs if e["ph"] == "M" and e["name"] == "thread_name"
               and e["pid"] == pid and e["args"]["name"] == "engine")
    slices = [e for e in evs if e.get("cat") == "span"]
    assert all((e["pid"], e["tid"], e["ph"]) == (pid, tid, "X") for e in slices)
    assert [e["name"] for e in slices] == [s.name for s in trace.spans]
    assert [e["args"] for e in slices] == [s.data for s in trace.spans]
    assert all(e["dur"] == pytest.approx(1e3) for e in slices)  # one tick, in us
    rest = [e for e in evs if e.get("cat") != "span" and e not in plain["traceEvents"]]
    assert rest == [next(e for e in evs if e["ph"] == "M" and e["tid"] == tid)]
    assert write_trace(trace.events, str(tmp_path / "t.json"), trace.spans) == "chrome"
    assert write_trace(trace.events, str(tmp_path / "t.jsonl"), trace.spans) == "jsonl"
    assert "decode.gather" not in (tmp_path / "t.jsonl").read_text()
    assert '"decode.gather"' in (tmp_path / "t.json").read_text()
    tr = TraceRecorder()
    tr.span("decode.gather", 0.5, 0.75, device_s=0.125, pool="p")
    (one,) = [e for e in chrome_trace(tr.events, tr.spans)["traceEvents"] if e["ph"] == "X"]
    assert (one["ts"], one["dur"], one["args"]) == (0.5e6, 0.25e6, {"device_ms": 125.0})
