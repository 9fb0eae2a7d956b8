"""Discrete-event simulator of a PD-disaggregated serving deployment (a
copy of ``repro.sim.simulator``).

Two engine clocks (prefill instance, decode instance) advance through a
shared timeline; arrivals are injected as the clocks pass them. The
simulator constructs its schedulers through the *same* policy registry
(`repro_torch.policies`) as the port's engine — the paper's algorithms are
exercised verbatim, and any `PolicySpec` accepted here is accepted there.

Fault injection: `FaultPlan` kills the decode instance at given times; all
in-flight decode requests lose their KV and re-enter the prefill queue
(Request.reset_for_restart), modeling the framework's recovery path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.pacer import DeliveryPacer
from repro_torch.core.predictor import PrefillThroughputEstimator
from repro_torch.core.request import Phase, Request
from repro_torch.obs.events import EventType, TraceRecorder
from repro_torch.policies import PolicySpec, make_decode, make_prefill
from repro_torch.sim.costmodel import CalibratedCostModel, PAPER_COST_MODEL


@dataclass(frozen=True)
class SimConfig:
    chunk_size: int = 8192  # chunked-prefill token budget per step
    # decode-node KV memory in tokens: the paper reports a memory-bound
    # decode regime ("KV cache memory is exhausted and new requests cannot
    # be admitted", §4.5) — ~600K tokens at ~0.5 MB/token on 4xH200 after
    # weights.
    kv_cap_tokens: int = 500_000
    max_decode_batch: int = 512
    step_noise_sigma: float = 0.0  # lognormal jitter on true step times
    prefix_cache_hit_frac: float = 0.0  # fraction of prompt served from cache
    pacer_mode: str = "immediate"
    seed: int = 0


@dataclass(frozen=True)
class FaultPlan:
    decode_failures: Tuple[float, ...] = ()  # times at which decode node dies
    recovery_time: float = 5.0  # seconds to bring up the replacement


@dataclass
class SimResult:
    requests: List[Request]
    prefill_busy: float = 0.0
    decode_busy: float = 0.0
    decode_steps: int = 0
    decode_tokens: int = 0
    packed_steps: int = 0  # kairos: steps where stragglers were delayed
    full_steps: int = 0  # steps decoding the whole active set
    max_active: int = 0
    makespan: float = 0.0
    config: Optional[SimConfig] = None

    def completed(self) -> List[Request]:
        return [r for r in self.requests if r.phase == Phase.DONE]


class DisaggSimulator:
    def __init__(
        self,
        cost: CalibratedCostModel = PAPER_COST_MODEL,
        prefill_policy: Union[str, PolicySpec] = "kairos-urgency",
        decode_policy: Union[str, PolicySpec] = "kairos-slack",
        sim_cfg: Optional[SimConfig] = None,
        fault_plan: Optional[FaultPlan] = None,
        lut: Optional[StepTimeLUT] = None,
        trace: Optional[TraceRecorder] = None,
        trace_label: str = "sim",
    ):
        if sim_cfg is None:
            sim_cfg = SimConfig()
        if fault_plan is None:
            fault_plan = FaultPlan()
        self.cost = cost
        self.cfg = sim_cfg
        self.faults = sorted(fault_plan.decode_failures)
        self.recovery = fault_plan.recovery_time
        self.rng = np.random.default_rng(sim_cfg.seed)

        # policies come from the shared registry — the same specs (and the
        # same classes) the live engine constructs from
        self.prefill_sched = make_prefill(prefill_policy)
        self.lut = lut or StepTimeLUT(analytic=cost.decode_lut_seed)
        self.decode_sched = make_decode(decode_policy, self.lut)
        self.mu = PrefillThroughputEstimator(mu=cost.prefill_throughput_seed())
        self.pacer = DeliveryPacer(mode=sim_cfg.pacer_mode)
        # observability (repro_torch.obs): None = tracing off. The simulator emits
        # the SAME event schema as the live backends at its cost-model
        # timestamps, so event-level parity with the engine can be asserted
        # (in the JAX package's tests). Emissions never touch the timeline.
        self.trace = trace
        self.trace_label = trace_label

    # ------------------------------------------------------------------ run
    def run(self, requests: Sequence[Request]) -> SimResult:
        cfg, cost = self.cfg, self.cost
        reqs = sorted(requests, key=lambda r: r.arrival)
        for r in reqs:
            if cfg.prefix_cache_hit_frac > 0:
                r.prefix_cached_tokens = int(r.input_len * cfg.prefix_cache_hit_frac)
        n = len(reqs)
        arr_i = 0  # next arrival to inject

        prefill_q: List[Request] = []
        transfer: List[Tuple[float, Request]] = []  # (ready_time, request)
        wait_adm: List[Request] = []  # transferred, waiting for KV admission
        active: List[Request] = []
        kv_used = 0

        tp = 0.0  # prefill clock
        td = 0.0  # decode clock
        res = SimResult(requests=list(reqs), config=cfg)
        faults = list(self.faults)
        decode_down_until = -1.0

        tr = self.trace
        lbl = self.trace_label

        def inject(up_to: float):
            nonlocal arr_i
            while arr_i < n and reqs[arr_i].arrival <= up_to:
                r = reqs[arr_i]
                prefill_q.append(r)
                arr_i += 1
                if tr is not None:
                    # the sim has no admission control: every arrival is
                    # SUBMIT + ADMIT at its declared arrival time
                    tr.emit(
                        EventType.SUBMIT, r.arrival, rid=r.rid, tenant=r.tenant,
                        pool=lbl, arrival=r.arrival, input_len=r.input_len,
                        output_len=r.output_len, slo_ttft=r.slo.ttft,
                        slo_tpot=r.slo.tpot, slo_class=r.slo_class,
                    )
                    tr.emit(
                        EventType.ADMIT, r.arrival, rid=r.rid, tenant=r.tenant,
                        pool=lbl, queue_depth=len(prefill_q),
                    )

        def noisy(t: float) -> float:
            if cfg.step_noise_sigma > 0:
                return t * float(self.rng.lognormal(0.0, cfg.step_noise_sigma))
            return t

        def admit(now: float):
            nonlocal kv_used
            ready = [x for x in transfer if x[0] <= now]
            for x in ready:
                transfer.remove(x)
                wait_adm.append(x[1])
            wait_adm.sort(key=lambda r: (r.prefill_finish or 0.0, r.rid))
            still = []
            for r in wait_adm:
                need = r.input_len + r.output_len
                if (
                    kv_used + need <= cfg.kv_cap_tokens
                    and len(active) < cfg.max_decode_batch
                ):
                    kv_used += need
                    r.phase = Phase.DECODE
                    r.decode_start = now
                    active.append(r)
                    if tr is not None:
                        tr.emit(
                            EventType.HANDOFF_ATTACH, now, rid=r.rid,
                            tenant=r.tenant, pool=lbl,
                        )
                else:
                    still.append(r)
            wait_adm[:] = still

        def handle_fault(now: float):
            """Decode node dies: KV lost, in-flight requests restart."""
            nonlocal kv_used, decode_down_until
            for r in list(active):
                active.remove(r)
                r.reset_for_restart()
                prefill_q.append(r)
            for _, r in list(transfer):
                r.reset_for_restart()
                prefill_q.append(r)
            transfer.clear()
            for r in list(wait_adm):
                r.reset_for_restart()
                prefill_q.append(r)
            wait_adm.clear()
            kv_used = 0
            decode_down_until = now + self.recovery

        done = 0
        while done < n:
            # --- next time each engine has work -----------------------------
            t_prefill_work = None
            if any(not r.prefill_done for r in prefill_q):
                t_prefill_work = tp
            elif arr_i < n:
                t_prefill_work = max(tp, reqs[arr_i].arrival)

            t_decode_work = None
            if active:
                t_decode_work = td
            elif transfer:
                t_decode_work = max(td, min(t for t, _ in transfer))
            elif wait_adm:
                t_decode_work = td  # admission retried each visit

            if t_prefill_work is None and t_decode_work is None:
                break  # nothing left anywhere (all done or unreachable)

            # step the engine whose work time is earlier
            if t_decode_work is None or (
                t_prefill_work is not None and t_prefill_work <= t_decode_work
            ):
                tp = t_prefill_work
                while faults and faults[0] <= tp:
                    handle_fault(faults.pop(0))
                inject(tp)
                tp, td = self._prefill_step(tp, td, prefill_q, transfer, res)
            else:
                td = t_decode_work
                if td < decode_down_until:
                    td = decode_down_until
                while faults and faults[0] <= td:
                    handle_fault(faults.pop(0))
                inject(td)
                td, kv_used, done = self._decode_step(
                    td, active, transfer, wait_adm, kv_used, done, res, admit, noisy
                )

        res.makespan = max(tp, td)
        # pacing (delivery timestamps)
        for r in reqs:
            if r.token_times and r.first_token_time is not None:
                r.delivery_times = self.pacer.delivery_times(
                    r.token_times, r.first_token_time, r.slo.tpot
                )
        return res

    # --------------------------------------------------------------- prefill
    def _emit_prefill_finish(self, r: Request, t_end: float, ready: float, depth: int) -> None:
        """PREFILL_END -> HANDOFF_QUEUED -> HANDOFF_START -> TOKEN at t_end —
        the exact order `ServeSession.step` emits on prefill completion, so
        the sequences compare equal modulo the pool tag."""
        tr = self.trace
        lbl = self.trace_label
        tr.emit(
            EventType.PREFILL_END, t_end, rid=r.rid, tenant=r.tenant,
            pool=lbl, queue_depth=depth,
        )
        tr.emit(EventType.HANDOFF_QUEUED, t_end, rid=r.rid, tenant=r.tenant, pool=lbl)
        tr.emit(
            EventType.HANDOFF_START, t_end, rid=r.rid, tenant=r.tenant,
            pool=lbl, ready_at=ready,
        )
        tr.emit(EventType.TOKEN, t_end, rid=r.rid, tenant=r.tenant, pool=lbl)

    def _prefill_step(self, tp, td, prefill_q, transfer, res):
        cfg, cost = self.cfg, self.cost
        tr = self.trace
        queue = [r for r in prefill_q if r.arrival <= tp and not r.prefill_done]
        if not queue:
            future = [r.arrival for r in prefill_q if not r.prefill_done]
            tp = max(tp, min(future)) if future else max(tp, td)
            return tp, td
        # degenerate: fully prefix-cached requests complete instantly
        for r in list(queue):
            if r.remaining_prefill_tokens == 0:
                r.prefill_finish = tp
                r.first_token_time = tp
                r.token_times.append(tp)
                r.n_generated = 1
                r.phase = Phase.TRANSFER
                prefill_q.remove(r)
                queue.remove(r)
                ready = tp + cost.transfer_time(r.input_len)
                transfer.append((ready, r))
                if tr is not None:
                    tr.emit(
                        EventType.PREFILL_START, tp, rid=r.rid,
                        tenant=r.tenant, pool=self.trace_label, take=0,
                    )
                    self._emit_prefill_finish(r, tp, ready, len(prefill_q))
        if not queue:
            return tp, td
        sel = self.prefill_sched.select(queue, tp, self.mu.mu, cfg.chunk_size)
        if not sel:
            tp += 0.001
            return tp, td
        chunks = []
        for r, take in sel:
            if tr is not None and r.prefilled_tokens == 0:
                tr.emit(
                    EventType.PREFILL_START, tp, rid=r.rid, tenant=r.tenant,
                    pool=self.trace_label, take=take,
                )
            r.phase = Phase.PREFILL
            offset = r.prefix_cached_tokens + r.prefilled_tokens
            chunks.append((take, offset))
        step_t = cost.prefill_chunk_time(chunks)
        t_end = tp + step_t
        total = 0
        for r, take in sel:
            r.prefilled_tokens += take
            total += take
            if r.prefill_done:
                r.prefill_finish = t_end
                r.first_token_time = t_end  # first token emitted by prefill
                r.token_times.append(t_end)
                r.n_generated = 1
                r.phase = Phase.TRANSFER
                prefill_q.remove(r)
                ready = t_end + cost.transfer_time(r.input_len)
                transfer.append((ready, r))
                if tr is not None:
                    self._emit_prefill_finish(r, t_end, ready, len(prefill_q))
        self.mu.update(total, step_t)
        res.prefill_busy += step_t
        return t_end, td

    # ---------------------------------------------------------------- decode
    def _decode_step(self, td, active, transfer, wait_adm, kv_used, done, res, admit, noisy):
        cfg, cost = self.cfg, self.cost
        admit(td)
        if not active:
            pending = [t for t, _ in transfer]
            if pending:
                td = max(td, min(pending))
            else:
                td += 0.001
            return td, kv_used, done

        batch, _delayed = self.decode_sched.select(active, td)
        step_t = noisy(cost.decode_step_time([r.seq_len for r in batch]))
        t_end = td + step_t
        if _delayed:
            res.packed_steps += 1
        else:
            res.full_steps += 1
        res.max_active = max(res.max_active, len(active))
        tr = self.trace
        lbl = self.trace_label
        if tr is not None and batch:
            tr.emit(
                EventType.DECODE_STEP, t_end, pool=lbl,
                batch=len(batch), step_time=step_t, active=len(active),
                tpot_budget=min(r.slo.tpot for r in batch),
            )
        for r in batch:
            r.n_generated += 1
            r.n_decoded += 1
            r.token_times.append(t_end)
            if tr is not None:
                tr.emit(EventType.TOKEN, t_end, rid=r.rid, tenant=r.tenant, pool=lbl)
            if r.decode_done:
                r.phase = Phase.DONE
                r.done_time = t_end
                active.remove(r)
                kv_used -= r.input_len + r.output_len
                done += 1
                if tr is not None:
                    tr.emit(
                        EventType.DONE, t_end, rid=r.rid, tenant=r.tenant,
                        pool=lbl, n_generated=r.n_generated,
                    )
        self.decode_sched.observe(batch, step_t)
        res.decode_busy += step_t
        res.decode_steps += 1
        res.decode_tokens += len(batch)
        return t_end, kv_used, done


def run_policy(
    requests: Sequence[Request],
    prefill_policy: Union[str, PolicySpec],
    decode_policy: Union[str, PolicySpec],
    cost: CalibratedCostModel = PAPER_COST_MODEL,
    sim_cfg: Optional[SimConfig] = None,
    fault_plan: Optional[FaultPlan] = None,
    trace: Optional[TraceRecorder] = None,
) -> SimResult:
    import copy

    reqs = copy.deepcopy(list(requests))
    sim = DisaggSimulator(
        cost, prefill_policy, decode_policy, sim_cfg, fault_plan, trace=trace
    )
    return sim.run(reqs)


def run_kairos(requests, **kw) -> SimResult:
    return run_policy(requests, "kairos-urgency", "kairos-slack", **kw)


def run_distserve(requests, **kw) -> SimResult:
    """Baseline: FCFS prefill + continuous batching (DistServe)."""
    return run_policy(requests, "fcfs", "continuous", **kw)


def run_kairos_plus(requests, **kw) -> SimResult:
    """Beyond-paper variant: urgency-plus prefill + greedy-fill decode."""
    return run_policy(requests, "kairos-urgency-plus", "kairos-slack-greedy", **kw)
