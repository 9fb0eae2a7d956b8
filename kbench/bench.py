"""One run of one cell: weights from the seed, the server, the warm-up,
the traffic through ``AsyncServeSession`` on a wall clock, the measured
window, the record the metric readers read, and the check of what was
served against the plain reference.

Virtual time is the session's: seconds since ``AsyncServeSession.start``
re-zeroed the server's ``MonotonicClock``. The window is
``[lead_in_s, lead_in_s + seconds]`` of it. The benchmark's own wrappers
time the engine's calls (``PrefillEngine.run_chunk``, ``DecodeEngine.step``,
each ending in a device sync) and the clients time every token they
receive; the traced run adds the session's ``TraceRecorder`` (its events and
the program's own spans, on the same clock) and a ``torch.profiler`` slice.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import importlib.util
import itertools
import pkgutil
import sys
import time
from typing import Callable, Dict, List, Optional, TextIO

import numpy as np
import torch

from kbench import correct as correct_mod
from kbench.profiling import Slicer
from kbench.spec import Cell, reader
from kbench.traffic.generator import Req
from kbench.weights import make_weights


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` from the configuration file's keys."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def engine_config(cfg: Dict):
    from repro_torch.serving.engine import EngineConfig

    e = dict(cfg["engine"])
    e["decode_buckets"] = tuple(e["decode_buckets"])
    return EngineConfig(max_len=cfg["max_len"], **e)


def _bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


class Spans:
    """Host-clock spans of the engine's calls, with what each computed,
    in virtual seconds. Wrapping is on the instances; the program is not
    edited."""

    def __init__(self, server, labelled: bool):
        self.server = server
        self.prefill: List[tuple] = []  # (t0, t1, take, start)
        self.decode: List[tuple] = []  # (t0, t1, lanes, bucket, kv_lens)
        self._labelled = labelled
        pre, dec = server.prefill, server.decode
        run_chunk, step = pre.run_chunk, dec.step
        buckets = server.ecfg.decode_buckets

        def wrapped_chunk(lr, take):
            r = lr.req
            start = r.prefix_cached_tokens + r.prefilled_tokens
            with self._range("kb.prefill_chunk"):
                t0 = self.now()
                out = run_chunk(lr, take)
                t1 = self.now()
            self.prefill.append((t0, t1, take, start))
            return out

        def wrapped_step(batch, gen):
            kv = [lr.req.seq_len for lr in batch]
            with self._range("kb.decode_step"):
                t0 = self.now()
                out = step(batch, gen)
                t1 = self.now()
            b = _bucket(len(batch), buckets)
            self.decode.append((t0, t1, len(batch), b, kv + [1] * (b - len(batch))))
            return out

        pre.run_chunk = wrapped_chunk
        dec.step = wrapped_step

    def now(self) -> float:
        return time.monotonic() - self.server._t0

    def _range(self, name: str):
        if self._labelled:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()


def warm_up(server, vocab: int) -> None:
    """Run every shape the traffic will use once, through the engine's own
    calls: ``max_slots`` prompts of two and a half chunks prefilled and
    handed to the decode pool, then one decode step at every bucket; then
    leave the server as built (``reset_for_restart``)."""
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import LiveRequest

    ecfg = server.ecfg
    rng = np.random.default_rng(0)
    n_in = 2 * ecfg.chunk_size + ecfg.chunk_size // 2
    live = []
    for i in range(ecfg.max_slots):
        req = Request(rid=i, arrival=0.0, input_len=n_in, output_len=8)
        lr = LiveRequest(req=req, tokens=rng.integers(2, vocab, size=n_in).tolist())
        while not req.prefill_done:
            take = min(ecfg.chunk_size, req.remaining_prefill_tokens)
            logits = server.prefill.run_chunk(lr, take)
        lr.tokens.append(int(np.argmax(logits)))
        req.n_generated = 1
        if not server.decode.admit(lr):
            raise RuntimeError("warm-up: the decode pool cannot hold max_slots requests")
        live.append(lr)
    for b in ecfg.decode_buckets:
        server.decode.step(live[:b], server._gen)
    for lr in live:
        server.decode.release(lr)
    server.reset_for_restart()


def kernel_wrappers() -> Dict[str, Callable[[], int]]:
    """The launch counters of the port's kernel wrappers, by
    ``<package>.<wrapper>``: every function with an integer ``launches``
    defined in a ``repro_torch.kernels.<package>.ops`` module."""
    import repro_torch.kernels as kernels

    out = {}
    for pkg in pkgutil.iter_modules(kernels.__path__):
        name = f"{kernels.__name__}.{pkg.name}.ops"
        if not pkg.ispkg or importlib.util.find_spec(name) is None:
            continue
        ops = importlib.import_module(name)
        for attr, fn in vars(ops).items():
            if (callable(fn) and getattr(fn, "__module__", None) == name
                    and isinstance(getattr(fn, "launches", None), int)):
                out[f"{pkg.name}.{attr}"] = lambda fn=fn: fn.launches
    return out


def _profiler_warm_up(device: torch.device) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device=device).sum().item()


async def _drive(server, cell: Cell, reqs: List[Req], seconds: float, trace: bool,
                 spans: Spans) -> Dict:
    from repro_torch.core.request import Request, SLOSpec
    from repro_torch.obs.events import TraceRecorder
    from repro_torch.serving.frontend import AsyncServeSession

    mix = cell.mix
    t_lead, t_end = mix.lead_in_s, mix.lead_in_s + seconds
    ttft_slo, tpot_slo = mix.slo
    recorder = TraceRecorder() if trace else None
    fe = AsyncServeSession(server, trace=recorder, stream_buffer=1 << 20)
    sess = fe.session
    rows: Dict[int, Dict] = {}
    prompts: Dict[int, List[int]] = {}
    backlog: Dict[str, int] = {}
    slicer = None
    if trace:
        from repro_torch.kernels.decode_attention.ops import decode_attention
        from repro_torch.kernels.prefill_attention.ops import prefill_attention

        length = min(5.0, 0.2 * seconds)
        slicer = Slicer(t_lead + 0.25 * seconds, length,
                        {"prefill_attention": lambda: prefill_attention.launches,
                         "decode_attention": lambda: decode_attention.launches},
                        kernel_wrappers())
    step, submit = sess.step, sess.submit

    def wrapped_step():
        now = spans.now()
        if slicer is not None:
            slicer.before_step(now)
        with spans._range("kb.session_step"):
            out = step()
        now = spans.now()
        if slicer is not None:
            slicer.after_step(now)
        for key, at in (("mid", t_lead + 0.5 * seconds), ("end", t_end)):
            if key not in backlog and now >= at:
                backlog[key] = len(sess.queue) + len(sess.waiting_adm)
        return out

    def wrapped_submit(request, prompt, on_token=None):
        rows[request.rid]["sent"] = spans.now()
        return submit(request, prompt, on_token)

    sess.step, sess.submit = wrapped_step, wrapped_submit

    def make(r: Req, due: float):
        prompts[r.idx] = r.prompt
        rows[r.idx] = dict(idx=r.idx, due=due, input_len=r.input_len, output_len=r.output_len,
                           times=[], sent=None, clipped=r.clipped)
        return Request(rid=r.idx, arrival=due, input_len=r.input_len, output_len=r.output_len,
                       slo=SLOSpec(ttft=ttft_slo, tpot=tpot_slo))

    async def consume(handle, row):
        async for _ in handle.stream():
            row["times"].append(spans.now())

    tasks = []
    fe.start()
    try:
        if mix.loop == "open":
            for r in reqs:
                h = await fe.submit(make(r, r.due), r.prompt, at=r.due)
                tasks.append(asyncio.ensure_future(consume(h, rows[r.idx])))
        else:
            pool = itertools.cycle(reqs)

            async def client():
                while spans.now() < t_end:
                    r = next(pool)
                    r = dataclasses.replace(r, idx=len(rows))
                    h = await fe.submit(make(r, spans.now()), r.prompt)
                    await consume(h, rows[r.idx])

            tasks = [asyncio.ensure_future(client()) for _ in range(mix.params["clients"])]
        while spans.now() < t_end:
            if fe._stepper is not None and fe._stepper.done():
                break  # the engine crashed: drain() below raises its error
            await asyncio.sleep(min(0.05, max(0.0, t_end - spans.now())))
        t_closed = spans.now()
        wall_at_window = server._t0 + t_lead
    finally:
        if slicer is not None:
            slicer.close()
        st, stepper_error = fe._stepper, None
        if st is not None and st.done() and not st.cancelled():
            stepper_error = st.exception()
        await fe.aclose()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    if stepper_error is not None:
        raise stepper_error
    done = {r.rid: list(sess.outputs.get(r.rid, [])) for r in sess.requests
            if r.phase.value == "done"}
    prefill_start: Dict[int, float] = {}
    steps, events, program_spans = [], [], []
    if recorder is not None:
        for ev in recorder.events:
            events.append((ev.type.value, ev.t, ev.rid, ev.data))
            if ev.type.value == "prefill_start":
                prefill_start.setdefault(ev.rid, ev.t)
            elif ev.type.value == "decode_step":
                steps.append((ev.t, ev.data["batch"], ev.data["step_time"]))
        program_spans = [(s.name, s.pool, s.t0, s.t1, s.device_s, s.data)
                         for s in recorder.spans]
    for rid, row in rows.items():
        row["prefill_start"] = prefill_start.get(rid)
    return dict(
        rows=rows, prompts=prompts, done=done, t_closed=t_closed, wall_at_window=wall_at_window,
        backlog=backlog, steps=steps, events=events, program_spans=program_spans,
        slicer=slicer,
        failed=sess.metrics.rejected,
    )


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
             device: str = "cuda", log: TextIO = sys.stderr,
             fault: Optional[Callable] = None, control: Optional[tuple] = None) -> Dict:
    """One run; returns the result line's object. ``fault`` (tests only)
    is called with the built server to plant a fault in the timed path;
    ``control`` (``kbench/control.py``) names reference precisions whose
    gaps are read too, returned under ``_check``."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import DisaggServer

    dev = torch.device(device)
    cfg = cell.config
    mcfg = model_config(cfg)
    model = build_model(mcfg)
    weights = make_weights(model.param_struct(), seed, dev)
    server = DisaggServer(model, weights, engine_config(cfg), device=dev)
    if fault is not None:
        fault(server)
    spans = Spans(server, labelled=trace)
    warm_up(server, mcfg.vocab_size)
    spans.prefill.clear()
    spans.decode.clear()
    if trace and dev.type == "cuda":
        _profiler_warm_up(dev)
    reqs = cell.mix.draw(seed, seconds, cfg["max_len"], mcfg.vocab_size)
    out = asyncio.run(_drive(server, cell, reqs, seconds, trace, spans))
    del reqs
    rec = dict(
        window=(cell.mix.lead_in_s, cell.mix.lead_in_s + seconds),
        t_closed=out["t_closed"], rows=list(out["rows"].values()),
        prefill_spans=spans.prefill, decode_spans=spans.decode, steps=out["steps"],
        events=out.pop("events"), program_spans=out.pop("program_spans"),
        model=cfg, setup_s=out["wall_at_window"] - t_process,
        profile=out["slicer"].result() if out["slicer"] is not None else None,
    )
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    _report(rec, out, peak, cell, log)
    t0, t1 = rec["window"]
    result = dict(
        correct=False,
        attempted=sum(t0 <= r["due"] < t1 for r in rec["rows"]),
        failed=int(out["failed"]),
        metrics=metrics,
        device=_device(dev, peak),
    )
    prof = rec["profile"]
    if trace:
        if prof is not None:
            result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = dict(
                device_ops=[[n, s] for n, s in prof["top_ops"]],
                idle_gaps=[[n, s] for n, s in prof["idle_gaps"]])
        else:
            print("[kbench] no complete profiler slice: the device metrics are left out",
                  file=log)
    # the program's state goes before the reference runs; the weights stay
    del server, spans, rec
    out.pop("slicer")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check = correct_mod.check(weights, cfg, out["prompts"], out["done"], seed, log, control,
                              root=cell.root)
    result["correct"] = check["correct"]
    if control is not None:
        result["_check"] = check
    result["checks"] = check["checks"]
    return result


def _device(dev: torch.device, peak: int) -> Dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                memory_peak_bytes=peak)


def _report(rec: Dict, out: Dict, peak: int, cell: Cell, log: TextIO) -> None:
    """The earlier lines: what the metrics rest on."""
    from kbench.yardstick import median

    t0, t1 = rec["window"]
    ttft_slo, tpot_slo = cell.mix.slo
    due = [r for r in rec["rows"] if t0 <= r["due"] < t1]
    ttft = [r["times"][0] - r["due"] for r in due if r["times"] and r["times"][0] <= t1]
    tpot = []
    met = 0
    for r in due:
        ts = [t for t in r["times"] if t <= t1]
        ok_ttft = bool(ts) and ts[0] - r["due"] <= ttft_slo
        if len(ts) >= 2:
            tp = (ts[-1] - ts[0]) / (len(ts) - 1)
            tpot.append(tp)
        else:
            tp = 0.0
        done = len(r["times"]) >= 1 and r["idx"] in out["done"] and r["times"][-1] <= t1
        met += int(ok_ttft and tp <= tpot_slo and done)
    late = [r["sent"] - r["due"] for r in rec["rows"] if r["sent"] is not None]
    clipped = sum(r["clipped"] for r in rec["rows"])
    p = lambda xs: f"{median(xs):.4f}" if xs else "none"  # noqa: E731
    print(f"[kbench] {cell.name}: {len(rec['rows'])} requests made, {len(due)} due in the "
          f"window [{t0:.1f}, {t1:.1f}] s (closed at {rec['t_closed']:.3f}); "
          f"{clipped} clipped to max_len {cell.config['max_len']} "
          f"({100 * clipped / max(1, len(rec['rows'])):.1f}%)", file=log)
    print(f"[kbench] attainment (TTFT <= {ttft_slo} s, TPOT <= {1e3 * tpot_slo:.0f} ms, done "
          f"in the window): {met}/{len(due)}; TTFT median {p(ttft)} s over {len(ttft)} with a "
          f"first token; TPOT median {p(tpot)} s over {len(tpot)} with two tokens or more",
          file=log)
    print(f"[kbench] generator late (sent - due): median {p(late)} s, max "
          f"{max(late) if late else 0:.4f} s over {len(late)}; lead-in {t0:.1f} s; set-up "
          f"{rec['setup_s']:.3f} s; backlog (prefill queue + waiting handoffs) at the window's "
          f"middle {out['backlog'].get('mid')} and end {out['backlog'].get('end')}; "
          f"peak memory {peak} B", file=log)
    prof = rec["profile"]
    if prof is not None and prof["slice_used"] > 1:
        print(f"[kbench] the first profiler slice lacked kernel events the wrappers counted; "
              f"the second slice is used", file=log)
