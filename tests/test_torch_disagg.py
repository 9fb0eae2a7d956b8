"""The port's P/D-split fleet (``repro_torch.serving.disagg``) on bridged
``llama3-8b-smoke`` f32 weights: the JAX package's ``DisaggFleetSession`` and
the port's, 1P:1D under ``never`` and 2P:1D under ``slack-aware``
deflection on one shared ManualClock, give identical tokens, token times,
summaries and event streams; and torch twins of the reference's
deflection, placement and handoff invariants (tests/test_disagg.py)."""
import asyncio
import copy
from dataclasses import dataclass, field
from typing import List

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
from repro.serving.disagg import DisaggFleetSession as JaxDisaggFleetSession  # noqa: E402
from repro.serving.engine import DisaggServer as JaxDisaggServer  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.policies import (  # noqa: E402
    PolicySpec,
    available_deflection_policies,
    available_policies,
    make_deflection,
)
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.disagg import DisaggFleetSession, DisaggSession  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402
from repro_torch.serving.router import RouterSession  # noqa: E402

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


def _server(both_models, clock=None, **kw):
    _, _, model, params = both_models
    return DisaggServer(model, params, EngineConfig(**{**ECFG, **kw}),
                        clock=clock if clock is not None else ManualClock(auto_step=1e-4),
                        device="cpu")


def _fleet(both_models, n_prefill=1, n_decode=1, **kw):
    """P+D servers on one shared ManualClock (the fleet requirement)."""
    clock = ManualClock(auto_step=1e-4)
    servers = [_server(both_models, clock=clock, **kw) for _ in range(n_prefill + n_decode)]
    return servers[:n_prefill], servers[n_prefill:]


def _jax_fleet(both_models, n_prefill=1, n_decode=1, **kw):
    jm, jp, _, _ = both_models
    clock = JaxManualClock(auto_step=1e-4)
    servers = [JaxDisaggServer(jm, jp, JaxEngineConfig(**{**ECFG, **kw}), clock=clock)
               for _ in range(n_prefill + n_decode)]
    return servers[:n_prefill], servers[n_prefill:]


def _requests(n=4, max_out=4, seed=0, arrival_gap=0.0, prompt_len=None, ttft=120.0,
              req_cls=Request, slo_cls=SLOSpec):
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(2, 256, prompt_len or int(rng.integers(4, 14)))))
               for _ in range(n)]
    return [
        (req_cls(rid=i, arrival=arrival_gap * i, input_len=len(p), output_len=max_out,
                 slo=slo_cls(ttft=ttft, tpot=10.0)), p)
        for i, p in enumerate(prompts)
    ]


def _drain(sess, max_steps=2000):
    for _ in range(max_steps):
        if not sess.has_work:
            return
        sess.step()
    raise AssertionError("disagg fleet did not drain")


# ------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("n_prefill,deflection", [(1, "never"), (2, "slack-aware")])
def test_disagg_fleet_matches_jax_fleet(both_models, n_prefill, deflection):
    """The same replay through the JAX DisaggFleetSession and the port's on
    one shared ManualClock(auto_step=1e-4) each, with a priced handoff:
    identical tokens, token_times, phases, summary() (handoff and
    deflection blocks included) and event streams."""
    kw = dict(transfer_lat=0.002)
    # a burst under tight TTFTs: slack-aware sees prefill pressure and deflects
    jpairs = _requests(n=8, max_out=4, seed=3, ttft=0.005,
                       req_cls=JaxRequest, slo_cls=JaxSLOSpec)
    tpairs = _requests(n=8, max_out=4, seed=3, ttft=0.005)

    async def run(fleet, pairs):
        async with fleet:
            return await fleet.replay(pairs, clients=3)

    jtrace, ttrace = JaxTraceRecorder(), TraceRecorder()
    jfleet = JaxDisaggFleetSession(*_jax_fleet(both_models, n_prefill, 1, **kw),
                                   deflection=deflection, trace=jtrace)
    tfleet = DisaggFleetSession(*_fleet(both_models, n_prefill, 1, **kw),
                                deflection=deflection, trace=ttrace)
    jout = asyncio.run(run(jfleet, jpairs))
    tout = asyncio.run(run(tfleet, tpairs))
    assert tout == jout
    for (jr, _), (tr, _) in zip(jpairs, tpairs, strict=True):
        assert tr.phase.value == jr.phase.value == "done"
        assert tr.token_times == jr.token_times, tr.rid
        assert tr.decode_start >= tr.prefill_finish
    ts = tfleet.summary()
    assert ts == jfleet.summary()
    assert [e.as_dict() for e in ttrace.events] == [e.as_dict() for e in jtrace.events]
    assert ts["handoff"]["transfers_completed"] == len(tpairs)
    assert tfleet.core.pool_labels() == jfleet.core.pool_labels()
    if deflection == "slack-aware":  # the case reaches the deflected path
        assert ts["deflection"]["deflected"] > 0
        assert ts["handoff"]["local_transfers"] == ts["deflection"]["deflected"]


# ------------------------------------------------ twins of tests/test_disagg.py
@dataclass
class FakeWorker:
    pending_prefill_tokens: int = 0
    queue_len: int = 0
    mu: float = 100.0
    free_slots: int = 4


@dataclass
class FakeFleet:
    prefill_pool: List[FakeWorker] = field(default_factory=list)
    decode_pool: List[FakeWorker] = field(default_factory=list)
    capacity: bool = True

    def decode_has_capacity(self):
        return self.capacity


def _req(input_len, ttft=1.0):
    return Request(rid=0, arrival=0.0, input_len=input_len, output_len=4,
                   slo=SLOSpec(ttft=ttft, tpot=10.0))


def test_deflection_registry_side():
    names = available_deflection_policies()
    assert list(names) == sorted(names)
    assert set(names) >= {"never", "short-prompt-threshold", "prefill-pressure", "slack-aware"}
    assert list(available_policies()["deflection"]) == list(names)


def test_never_deflect_always_declines():
    fleet = FakeFleet(prefill_pool=[FakeWorker(pending_prefill_tokens=10_000)],
                      decode_pool=[FakeWorker()])
    pol = make_deflection("never")
    assert pol.name == "never"
    assert pol.decide(fleet, _req(2), [1, 2]) is False


def test_short_prompt_threshold_is_load_blind():
    fleet = FakeFleet(prefill_pool=[FakeWorker()], decode_pool=[FakeWorker()])
    pol = make_deflection("short-prompt-threshold")
    assert pol.decide(fleet, _req(8), [0] * 8)
    assert not pol.decide(fleet, _req(9), [0] * 9)
    fleet.capacity = False
    assert not pol.decide(fleet, _req(8), [0] * 8)


def test_prefill_pressure_watermark_is_pool_total():
    pol = make_deflection("prefill-pressure")
    idle = FakeFleet(prefill_pool=[FakeWorker(), FakeWorker()], decode_pool=[FakeWorker()])
    assert not pol.decide(idle, _req(4), [0] * 4)
    pressured = FakeFleet(
        prefill_pool=[FakeWorker(pending_prefill_tokens=6), FakeWorker()],
        decode_pool=[FakeWorker()],
    )
    assert pol.decide(pressured, _req(4), [0] * 4)
    assert not pol.decide(pressured, _req(40), [0] * 40)
    pressured.capacity = False
    assert not pol.decide(pressured, _req(4), [0] * 4)


def test_prefill_pressure_watermark_override():
    pol = make_deflection(PolicySpec("prefill-pressure", {"watermark_tokens": 100}))
    fleet = FakeFleet(prefill_pool=[FakeWorker(pending_prefill_tokens=99)],
                      decode_pool=[FakeWorker()])
    assert not pol.decide(fleet, _req(4), [0] * 4)
    fleet.prefill_pool[0].pending_prefill_tokens = 100
    assert pol.decide(fleet, _req(4), [0] * 4)


def test_slack_aware_deflects_only_when_decode_wins():
    pol = make_deflection("slack-aware")
    fast = FakeFleet(prefill_pool=[FakeWorker(mu=1000.0)], decode_pool=[FakeWorker(mu=1000.0)])
    assert not pol.decide(fast, _req(4, ttft=1.0), [0] * 4)
    slow = FakeFleet(prefill_pool=[FakeWorker(pending_prefill_tokens=500, mu=100.0)],
                     decode_pool=[FakeWorker(mu=100.0)])
    assert pol.decide(slow, _req(4, ttft=1.0), [0] * 4)
    slow.decode_pool[0].pending_prefill_tokens = 500
    assert not pol.decide(slow, _req(4, ttft=1.0), [0] * 4)


def test_fleet_requires_one_shared_clock(both_models):
    with pytest.raises(ValueError, match="share one Clock"):
        DisaggSession([_server(both_models)], [_server(both_models)])


def test_fleet_requires_both_pools(both_models):
    prefill, _ = _fleet(both_models, 1, 1)
    with pytest.raises(ValueError, match="prefill and >= 1 decode"):
        DisaggSession(prefill, [])


def test_prefill_placement_round_robins_an_idle_pool(both_models):
    prefill, decode = _fleet(both_models, 2, 1)
    sess = DisaggSession(prefill, decode)
    for r, p in _requests(n=4, prompt_len=6):
        sess.submit(r, p)
    labels = sess.pool_labels()["prefill"]
    assert sorted(labels.values()) == ["prefill:0", "prefill:0", "prefill:1", "prefill:1"]
    assert [w.assigned for w in sess.prefill_pool] == [2, 2]


def test_cancel_mid_handoff_reclaims_everything(both_models):
    """A cancel while the KV is on the wire reclaims the transfer-window
    entry, the prefill cache, and the decode slot reserved at transfer
    start."""
    prefill, decode = _fleet(both_models, 1, 1, transfer_lat=0.5)
    sess = DisaggSession(prefill, decode)
    (r, p), = _requests(n=1)
    sess.submit(r, p)
    sess.step()
    assert r.phase == Phase.TRANSFER
    assert len(sess.inflight) == 1
    tr = sess.inflight[0]
    assert len(tr.dst.server.decode.alloc.free) == 3
    assert sess.cancel(r.rid)
    assert r.phase == Phase.CANCELLED
    assert not sess.inflight and not sess.pending_handoff
    assert tr.lr.prefill_cache is None
    assert len(tr.dst.server.decode.alloc.free) == 4
    assert sess.handoff.transfers_cancelled == 1
    assert not sess.has_work
    assert sess.metrics.cancelled == 1 and r.rid in sess.metrics.cancelled_rids


def test_bounded_inflight_window_queues_handoffs(both_models):
    prefill, decode = _fleet(both_models, 1, 1, transfer_lat=0.01)
    sess = DisaggSession(prefill, decode, max_inflight_transfers=1)
    pairs = _requests(n=3)
    for r, p in pairs:
        sess.submit(r, p)
    _drain(sess)
    h = sess.handoff_summary()
    assert all(r.phase == Phase.DONE for r, _ in pairs)
    assert h["transfers_completed"] == 3
    assert h["inflight_peak"] == 1
    assert h["queued_peak"] >= 1
    assert h["queue_wait_total"] > 0.0 and h["queue_wait_max"] > 0.0


@pytest.mark.parametrize("page_size", [None, 16])
def test_handoff_lands_the_prefill_kv_in_the_decode_server(both_models, page_size):
    """The cross-server handoff copies the prefill server's KV into the
    decode server's slot (or pages): a 1P:1D fleet's tokens equal a single
    server's, slot and paged. Paged, the later prompts that share the
    first one's 32-token head link its pages in the decode server's pool
    and prefill on the other server from the head copied out of it."""
    rng = np.random.default_rng(6)
    head = list(map(int, rng.integers(2, 256, 32)))
    prompts = [head + list(map(int, rng.integers(2, 256, n))) for n in (5, 9, 3)]
    prompts.insert(1, list(map(int, rng.integers(2, 256, 20))))
    pairs = [(Request(rid=i, arrival=0.02 * i, input_len=len(p), output_len=5,
                      slo=SLOSpec(ttft=120.0, tpot=10.0)), p) for i, p in enumerate(prompts)]
    single = _server(both_models, page_size=page_size).serve(copy.deepcopy(pairs))
    prefill, decode = _fleet(both_models, 1, 1, page_size=page_size)
    sess = DisaggSession(prefill, decode)
    now = sess.server._now
    for r, p in pairs:
        while now() < r.arrival:
            if sess.has_work:
                sess.step()
            else:
                sess.server.clock.sleep(0.001)
        sess.submit(r, p)
    _drain(sess)
    assert sess.outputs == single
    assert sess.handoff_summary()["cross_transfers"] == len(pairs)
    assert decode[0].decode.alloc.live_tokens == {}
    if page_size:
        assert sess.summary()["prefix"]["hit_tokens"] == 2 * 32


def test_1p1d_never_deflection_is_bit_identical_to_router(both_models):
    """A 1P:1D fleet under `never` deflection replays bit for bit against a
    1-replica router fleet on a ManualClock: splitting prefill from decode
    adds no clock reads."""
    pairs_router = _requests(n=5, max_out=4, seed=2, arrival_gap=0.01)
    pairs_disagg = copy.deepcopy(pairs_router)

    async def run_router():
        router = RouterSession([_server(both_models)], policy="round-robin")
        async with router:
            return await router.replay(pairs_router, clients=3)

    async def run_disagg():
        fleet = DisaggFleetSession(*_fleet(both_models, 1, 1), deflection="never")
        async with fleet:
            return await fleet.replay(pairs_disagg, clients=3)

    assert asyncio.run(run_router()) == asyncio.run(run_disagg())
    for (rr, _), (rd, _) in zip(pairs_router, pairs_disagg, strict=True):
        assert rr.phase == rd.phase == Phase.DONE
        assert rr.ttft() == rd.ttft()
        assert rr.mean_tpot() == rd.mean_tpot()
        assert rr.token_times == rd.token_times
