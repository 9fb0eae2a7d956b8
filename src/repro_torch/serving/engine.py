"""Disaggregated serving engine on PyTorch, driven by the Kairos schedulers
(port of ``repro.serving.engine``).

PrefillEngine owns a prefill cache per in-flight request and executes the
chunked prefill steps the prefill scheduler chooses (urgency/FCFS/...).
DecodeEngine owns the slot cache (or the page pool); each step the decode
scheduler (slack-guided / continuous) picks the sub-batch, which is
gathered into a power-of-two bucket and decoded; the slot layout scatters
the lanes back, the paged layout writes back only the one new KV row of
each lane. Observed step times feed the LUT and the prefill-throughput
estimator online.

The session reads its clock around the engine's steps, so every step
returns only once the device has finished it: decode and the last prefill
chunk by copying their result to the host, an intermediate prefill chunk
and a KV attach by synchronizing. Otherwise the schedulers would learn
launch times instead of step times.

Engine model families: the attention decoders (dense, moe and vlm), as the
reference engine serves (DESIGN.md §engine-scope), and it refuses an
encoder-decoder model when it is built; prompts are tokens for every family.
An alternating local/global model (gemma2) is served only at
``max_len <= sliding_window``: above it the decode cache would be the ring,
into which chunked prefill does not write (the reference's chunk fails
there, ROADMAP C6), so the engine refuses such a configuration when it is
built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.lut import StepTimeLUT
from repro_torch.core.predictor import PrefillThroughputEstimator
from repro_torch.core.request import Request
from repro_torch.device import DeviceLike, resolve_device, synchronize

if TYPE_CHECKING:  # import for annotation only: engine stays obs-free
    from repro_torch.obs.events import TraceRecorder
    from repro_torch.serving.probe import Probe
from repro_torch.models.model import Model, cache_struct
from repro_torch.models.transformer import chunk_prefill_step, decode_step
from repro_torch.policies import PolicySpec, make_decode, make_prefill
from repro_torch.serving.clock import Clock, MonotonicClock
from repro_torch.serving.kvcache import (
    PageAllocator,
    SlotAllocator,
    gather_pages,
    gather_slots,
    scatter_pages,
    scatter_slots,
)
from repro_torch.serving.prefixcache import PrefixCache
from repro_torch.serving.probe import OFF
from repro_torch.serving.sampler import sample
from repro_torch.sim.costmodel import CalibratedCostModel


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 256
    chunk_size: int = 64
    kv_cap_tokens: int = 1 << 16
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    eos_token: int = 1
    temperature: float = 0.0
    # policy specs resolved through the repro_torch.policies registry: a
    # registered name, or a PolicySpec carrying construction kwargs
    prefill_policy: Union[str, PolicySpec] = "kairos-urgency"
    decode_policy: Union[str, PolicySpec] = "kairos-slack"
    slo_margin: float = 0.9
    # virtual time: 1.0 => wall clock; larger stretches SLOs for slow devices
    time_scale: float = 1.0
    # ServeSession admission control: max requests waiting in the prefill
    # queue before submits are shed; None = unbounded
    admission_queue_depth: Optional[int] = None
    # per-tenant bound on queued requests, on top of the global bound
    tenant_queue_depth: Optional[int] = None
    # KV-handoff pricing (`CalibratedCostModel.transfer_time`: lat + tokens
    # * bytes / bw), in engine virtual seconds
    transfer_lat: float = 0.002
    transfer_bw: float = 900e9
    kv_bytes_per_token: float = 500e3
    # paged KV: a page size switches the decode cache from one contiguous
    # max_len slot per request to a pool of fixed-size pages with
    # per-request page tables and an engine-owned page-mapped prefix cache.
    # None keeps the slot layout. max_len must divide evenly into pages.
    page_size: Optional[int] = None
    # pool capacity in pages; None sizes it to max_slots full-length requests
    cache_pages: Optional[int] = None


@dataclass
class LiveRequest:
    req: Request
    tokens: List[int]  # prompt + generated
    slot: Optional[int] = None
    prefill_cache: Optional[Dict] = None
    # earliest virtual time the prefill->decode KV handoff may complete
    # (prefill_finish + CostModel.transfer_time); None until prefill is done
    transfer_ready_at: Optional[float] = None
    # paged KV: prefix pages shared from the radix cache (set at submit),
    # the engine whose pool holds them (prefill seeds its cache from it),
    # and the page table built at reserve time
    shared_pages: Optional[Tuple[int, ...]] = None
    kv_src: Optional["DecodeEngine"] = None
    page_table: Optional[List[int]] = None


class PrefillEngine:
    def __init__(self, model: Model, params: Dict, ecfg: EngineConfig, device: torch.device):
        self.model, self.params, self.ecfg, self.device = model, params, ecfg, device
        # lent by a tracing session for one step (`serving/probe.py`)
        self.probe: Optional["Probe"] = None

    def new_cache(self) -> Dict:
        return self.model.init_cache(1, self.ecfg.max_len, device=self.device)

    def _seed_cache(self, lr: LiveRequest) -> Dict:
        """Build lr's prefill cache pre-loaded with its shared prefix pages:
        the chunk loop starts at ``prefix_cached_tokens``, so the attention
        over the skipped head reads KV copied out of the source engine's
        page pool (positions ``[0, hit)``) instead of recomputing it."""
        cache = self.new_cache()
        src = lr.kv_src
        pages = lr.shared_pages
        if src is None or not pages:
            return cache
        ps = src.page_size
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for name, leaf in cache.items():
            pool = src.pool[name]  # (L, n_pages, ps, ...)
            head = pool.index_select(1, idx)  # (L, n_shared, ps, ...)
            leaf[:, :, : len(pages) * ps] = head.reshape(
                pool.shape[0], 1, len(pages) * ps, *pool.shape[3:]
            )
        return cache

    def run_chunk(self, lr: LiveRequest, take: int) -> Optional[np.ndarray]:
        """Prefill `take` tokens of lr; returns last logits if prompt done."""
        r = lr.req
        ecfg = self.ecfg
        start = r.prefix_cached_tokens + r.prefilled_tokens
        ph = OFF if self.probe is None else self.probe.phases()
        ph.next("prefill.chunk", rid=r.rid, start=start, take=take)
        if lr.prefill_cache is None:
            lr.prefill_cache = self._seed_cache(lr)
        chunk = lr.tokens[start : start + take]
        pad = ecfg.chunk_size - len(chunk)
        toks = torch.tensor([chunk + [0] * pad], dtype=torch.long, device=self.device)
        logits, lr.prefill_cache = chunk_prefill_step(
            self.params, toks, [start], [len(chunk)], self.model.cfg, lr.prefill_cache
        )
        r.prefilled_tokens += take
        ph.fence()
        if r.prefill_done:
            out = logits[0].cpu().numpy()  # the copy waits for the chunk
        else:
            out = None
            synchronize(self.device)
        ph.end()
        return out


class DecodeEngine:
    def __init__(self, model: Model, params: Dict, ecfg: EngineConfig, device: torch.device):
        self.model, self.params, self.ecfg, self.device = model, params, ecfg, device
        self.probe: Optional["Probe"] = None  # as PrefillEngine.probe
        # slot ids stay the batch-lane identity in both layouts; in paged
        # mode they charge 0 tokens (the page pool is the capacity)
        self.alloc = SlotAllocator(ecfg.max_slots, ecfg.kv_cap_tokens)
        self.page_size = ecfg.page_size
        if self.page_size is not None:
            self._init_paged(model.cfg)
        else:
            self.pages = None
            self.prefix = None
            self.pool = None
            # +1: lane max_slots is non-allocatable scratch for pad lanes —
            # padding into a LIVE slot would overwrite its position-0 KV
            self.cache = model.init_cache(ecfg.max_slots + 1, ecfg.max_len, device=device)
            self.scratch_slot = ecfg.max_slots

    def _init_paged(self, cfg) -> None:
        ecfg = self.ecfg
        ps = self.page_size
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        if ecfg.max_len % ps:
            raise ValueError(
                f"max_len={ecfg.max_len} must be a multiple of page_size={ps}"
            )
        leaves = set(cache_struct(cfg, 1, ps))
        if leaves != {"k", "v"}:
            raise ValueError(
                f"paged KV requires a plain k/v attention cache; family "
                f"{cfg.family!r} has leaves {sorted(leaves)}"
            )
        self.pages_per_req = ecfg.max_len // ps
        n_pages = ecfg.cache_pages or ecfg.max_slots * self.pages_per_req
        self.cache = None
        # +1: the last pool page is non-allocatable scratch for pad lanes
        # and unused page-table tails
        self.pool = self.model.init_cache(n_pages + 1, ps, device=self.device)
        self.scratch_page = n_pages
        self.pages = PageAllocator(page_size=ps, n_pages=n_pages)
        # the engine-owned radix cache: nodes map prefix blocks to live
        # pages in `self.pool`; it doubles as the allocator's pressure evictor
        self.prefix = PrefixCache(block=ps, pages=self.pages)

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    def reserve(self, lr: LiveRequest) -> bool:
        """Reserve decode capacity for lr without copying KV into it yet.

        Slot mode charges the token budget (prefix hits granted back as a
        credit); paged mode builds the page table, linking shared prefix
        pages instead of drawing fresh ones.
        """
        r = lr.req
        if self.pages is None:
            need = r.input_len + r.output_len
            slot = self.alloc.alloc(need, credit=r.prefix_hit_tokens)
            if slot is None:
                return False
            lr.slot = slot
            return True
        slot = self.alloc.alloc(0)
        if slot is None:
            return False
        shared = tuple(lr.shared_pages or ())
        if lr.kv_src is not self:
            # a foreign pool's page ids mean nothing here; the seeded
            # prefill cache carries the head bytes, attach writes them
            shared = ()
        need = min(r.input_len + r.output_len, self.ecfg.max_len)
        table = self.pages.alloc_table(slot, need, shared)
        if table is None:
            self.alloc.release(slot)
            return False
        lr.slot = slot
        lr.page_table = table
        return True

    def attach(self, lr: LiveRequest) -> None:
        """Copy lr's prefill cache (1, max_len) into its reserved slot/pages."""
        if self.pages is None:
            scatter_slots(
                self.model.cfg, self.cache, lr.prefill_cache,
                torch.tensor([lr.slot], dtype=torch.long, device=self.device),
            )
            lr.prefill_cache = None
            synchronize(self.device)
            return
        r = lr.req
        ps = self.page_size
        table = lr.page_table
        n_shared = len(lr.shared_pages or ())  # already live in this pool?
        if lr.kv_src is not self:
            n_shared = 0  # head bytes were seeded from another engine's pool
        if len(table) > n_shared:
            fresh = torch.tensor(table[n_shared:], dtype=torch.long, device=self.device)
            for name, leaf in self.pool.items():
                src = lr.prefill_cache[name]  # (L, 1, max_len, ...)
                blocks = src.reshape(src.shape[0], self.ecfg.max_len // ps, ps, *src.shape[3:])
                leaf[:, fresh] = blocks[:, n_shared : len(table)]
        lr.prefill_cache = None
        synchronize(self.device)
        # index the landed prompt in the radix cache: later prompts sharing
        # this head link these pages instead of recomputing the KV
        self.prefix.assign_pages(lr.tokens[: r.input_len], table)

    def admit(self, lr: LiveRequest) -> bool:
        """Transfer prefill KV into decode capacity (the PD handoff)."""
        if not self.reserve(lr):
            return False
        self.attach(lr)
        return True

    def release(self, lr: LiveRequest) -> None:
        if self.prefix is not None:
            # drop the rid's radix pins whether or not it ever got a slot
            self.prefix.release(lr.req.rid)
        if lr.slot is not None:
            if self.pages is not None:
                self.pages.release_table(lr.slot)
                lr.page_table = None
            self.alloc.release(lr.slot)
            lr.slot = None

    def step(self, batch: List[LiveRequest], generator: Optional[torch.Generator]) -> np.ndarray:
        """One decode step over the scheduler-chosen sub-batch: gather its
        cache lanes into a bucket and decode. The slot layout scatters the
        lanes back; the paged layout writes back only the K/V row the step
        wrote in each lane, at its page-table position."""
        ecfg = self.ecfg
        cfg = self.model.cfg
        bs = _bucket(len(batch), ecfg.decode_buckets)
        ph = OFF if self.probe is None else self.probe.phases()
        ph.next("decode.gather")
        toks = [lr.tokens[-1] for lr in batch] + [0] * (bs - len(batch))
        pos = [lr.req.seq_len - 1 for lr in batch] + [0] * (bs - len(batch))
        toks_t = torch.tensor(toks, dtype=torch.long, device=self.device)[:, None]
        pos_t = torch.tensor(pos, dtype=torch.int32, device=self.device)
        if self.pages is not None:
            p, sp, ps = self.pages_per_req, self.scratch_page, self.page_size
            rows = [lr.page_table + [sp] * (p - len(lr.page_table)) for lr in batch]
            rows += [[sp] * p] * (bs - len(batch))  # pad lanes write scratch only
            page_idx = torch.tensor(rows, dtype=torch.long, device=self.device)
            # each lane's new row, as a row of the gathered lanes and of the
            # pool; built before the forward, as a copy to the card waits for it
            new_at = torch.tensor(
                [[i * ecfg.max_len + q for i, q in enumerate(pos)],
                 [r[q // ps] * ps + q % ps for r, q in zip(rows, pos)]],
                dtype=torch.long, device=self.device,
            )
            sub = gather_pages(cfg, self.pool, page_idx)
            ph.next("decode.forward")
            logits, sub = decode_step(self.params, toks_t, pos_t, cfg, sub)
            ph.next("decode.scatter")
            # decode writes only at a request's own position, never into a
            # shared prefix page (`scatter_pages`), so that row is all the
            # step changed: write it through a one-row-a-page view of the pool
            new = {n: leaf.flatten(1, 2).index_select(1, new_at[0]).unsqueeze(2)
                   for n, leaf in sub.items()}
            pool_rows = {n: leaf.view(leaf.shape[0], -1, 1, *leaf.shape[3:])
                         for n, leaf in self.pool.items()}
            scatter_pages(cfg, pool_rows, new, new_at[1, :, None])
        else:
            slots = [lr.slot for lr in batch] + [self.scratch_slot] * (bs - len(batch))
            slot_idx = torch.tensor(slots, dtype=torch.long, device=self.device)
            sub = gather_slots(cfg, self.cache, slot_idx)
            ph.next("decode.forward")
            logits, sub = decode_step(self.params, toks_t, pos_t, cfg, sub)
            ph.next("decode.scatter")
            scatter_slots(cfg, self.cache, sub, slot_idx)
        ph.next("decode.sample")
        toks_out = sample(logits, temperature=ecfg.temperature, generator=generator)
        ph.next("decode.wait", device=False)
        out = toks_out.cpu().numpy()[: len(batch)]  # the copy waits for the step
        ph.end()
        return out


class DisaggServer:
    """End-to-end disaggregated server on PyTorch compute.

    Virtual time = (wall time since start) * time_scale, so SLO arithmetic
    runs unchanged whatever the device's speed. ``device`` defaults to
    "cuda" and raises when no card is present; pass "cpu" to run the plain
    path on the CPU.
    """

    def __init__(
        self,
        model: Model,
        params: Dict,
        ecfg: EngineConfig,
        clock: Optional[Clock] = None,
        trace: Optional["TraceRecorder"] = None,
        device: DeviceLike = "cuda",
    ):
        cfg = model.cfg
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: the engine serves the decoder-only attention families (dense, "
                "moe, vlm; DESIGN.md §engine-scope); run an encoder-decoder model through "
                "Model.prefill / Model.decode")
        if "k_local" in cache_struct(cfg, 1, ecfg.max_len):
            raise ValueError(
                f"{cfg.name}: max_len={ecfg.max_len} exceeds sliding_window="
                f"{cfg.sliding_window}, so the decode cache would be the ring cache, which "
                "chunked prefill does not fill (ROADMAP C6); serve at max_len <= "
                f"{cfg.sliding_window}")
        self.model, self.ecfg = model, ecfg
        self.device = resolve_device(device)
        self.clock: Clock = clock if clock is not None else MonotonicClock()
        # default trace sink for sessions built over this server
        self.trace = trace
        self.prefill = PrefillEngine(model, params, ecfg, self.device)
        self.decode = DecodeEngine(model, params, ecfg, self.device)
        self._init_sched_state()
        self.cost = CalibratedCostModel(
            transfer_lat=ecfg.transfer_lat,
            kv_bytes_per_token=ecfg.kv_bytes_per_token,
            transfer_bw=ecfg.transfer_bw,
        )
        self._t0 = self.clock.monotonic()
        self.last_session = None  # ServeSession of the most recent serve()

    def _init_sched_state(self) -> None:
        """(Re)build every piece of adaptive scheduling state."""
        ecfg = self.ecfg
        self.prefill_sched = make_prefill(ecfg.prefill_policy)
        analytic = lambda b, s: 1e-3 * (1 + 0.05 * b + s / 4096.0)
        self.lut = StepTimeLUT(analytic=analytic, seq_buckets=[16, 32, 64, 128, 256, 512])
        # slo_margin is a soft default: applied to policies that take it
        self.decode_sched = make_decode(
            ecfg.decode_policy, self.lut, slo_margin=ecfg.slo_margin
        )
        self.mu = PrefillThroughputEstimator(mu=2000.0)
        # sampling randomness: the reference's jax.random.key(0)
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    # ------------------------------------------------------------------ time
    def _now(self) -> float:
        return (self.clock.monotonic() - self._t0) * self.ecfg.time_scale

    def peek_now(self) -> float:
        """Observation-free virtual now: the control plane's clock read.
        Unlike `_now` this never charges a `ManualClock.auto_step`, so a
        fleet controller may poll at any frequency without perturbing the
        replica's deterministic timing."""
        return (self.clock.peek() - self._t0) * self.ecfg.time_scale

    def reset_clock(self) -> None:
        """Re-zero virtual time (arrivals are relative to this origin);
        virtual clocks re-zero exactly to their construction origin."""
        if hasattr(self.clock, "reset"):
            origin = self.clock.reset()
            self._t0 = 0.0 if origin is None else origin
        else:
            self._t0 = self.clock.monotonic()

    # --------------------------------------------------------------- restart
    def reset_for_restart(self) -> None:
        """Return the server to its just-constructed state: the live half of
        `dist/fault.py::plan_recovery`'s final step. Drops every decode slot
        (the KV is gone; survivors re-prefill restored requests), rebuilds
        the adaptive scheduler state, and re-zeroes the clock, so the
        restarted replica serves exactly as a freshly built one."""
        ecfg = self.ecfg
        # drop the old cache before allocating the new one: at full width a
        # restart would otherwise hold two decode caches for a moment
        if self.decode.paged:
            # the pool, allocator, and radix cache are one consistent unit
            self.decode.pool = None
            self.decode._init_paged(self.model.cfg)
        else:
            self.decode.cache = None
            self.decode.cache = self.model.init_cache(
                ecfg.max_slots + 1, ecfg.max_len, device=self.device
            )
        self.decode.alloc = SlotAllocator(ecfg.max_slots, ecfg.kv_cap_tokens)
        self._init_sched_state()
        self.last_session = None
        self.reset_clock()

    # ------------------------------------------------------------------ serve
    def serve(self, requests: List[Tuple[Request, List[int]]]) -> Dict[int, List[int]]:
        """Serve (Request, prompt_tokens) pairs; returns rid -> output tokens.

        A thin offline wrapper over `ServeSession.run`; inspect
        ``self.last_session.summary()`` for the session metrics.
        """
        from repro_torch.serving.session import ServeSession  # avoid import cycle

        for req, prompt in requests:
            if req.input_len != len(prompt):
                raise ValueError(
                    f"request rid={req.rid} declares input_len={req.input_len} "
                    f"but prompt has {len(prompt)} tokens"
                )
        session = ServeSession(self)
        self.last_session = session
        return session.run(requests)


def reference_generate(
    model: Model, params: Dict, prompt: List[int], n_new: int, max_len: int, eos: int = 1
) -> List[int]:
    """Scheduling-free greedy reference: prefill + sequential decode, on the
    device the parameters live on."""
    cfg = model.cfg
    dev = params["embed"].device
    inputs = torch.tensor([prompt], dtype=torch.long, device=dev)
    logits, _ = model.prefill(params, dict(inputs=inputs))
    cache = model.init_cache(1, max_len, device=dev)
    # rebuild the cache by chunk-prefilling the whole prompt at once
    logits2, cache = chunk_prefill_step(params, inputs, [0], [len(prompt)], cfg, cache)
    np.testing.assert_allclose(
        logits.float().cpu().numpy(), logits2.float().cpu().numpy(), rtol=2e-2, atol=2e-2
    )
    out = [int(torch.argmax(logits2[0]))]
    toks = list(prompt) + out
    for _ in range(n_new - 1):
        if out[-1] == eos or len(toks) >= max_len - 1:
            break
        lg, cache = decode_step(
            params,
            torch.tensor([[toks[-1]]], dtype=torch.long, device=dev),
            torch.tensor([len(toks) - 1], dtype=torch.int32, device=dev),
            cfg,
            cache,
        )
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
        toks.append(tok)
    return out
