"""The port's prefix-aware router (``repro_torch.serving.router``) on bridged
``llama3-8b-smoke`` f32 weights: the JAX package's ``RouterSession`` and the
port's, with 1 and 2 replicas on ManualClocks and the same requests, give
identical tokens, token times, summaries and event streams; and torch twins
of the reference's routing invariants (tests/test_prefix_router.py) and of
the registry's enumeration (tests/test_policies_registry.py)."""
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
from repro.serving.engine import DisaggServer as JaxDisaggServer  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.router import RouterSession as JaxRouterSession  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.policies import (  # noqa: E402
    available_autoscaler_policies,
    available_decode_policies,
    available_deflection_policies,
    available_policies,
    available_prefill_policies,
    available_router_policies,
    make_router,
)
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402
from repro_torch.serving.frontend import AsyncServeSession  # noqa: E402
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


def _shared_head_requests(req_cls, slo_cls, n=8, head=32, max_out=4):
    """Half the prompts share a 32-token head (two 16-token blocks, two
    pages of 16), so prefix affinity and paged reuse are real."""
    rng = np.random.default_rng(4)
    shared = list(map(int, rng.integers(2, 256, head)))
    pairs = []
    for i in range(n):
        tail = list(map(int, rng.integers(2, 256, int(rng.integers(3, 9)))))
        prompt = (shared + tail) if i % 2 else list(map(int, rng.integers(2, 256, head))) + tail
        pairs.append((req_cls(rid=i, arrival=0.003 * i, input_len=len(prompt),
                              output_len=max_out, slo=slo_cls(ttft=120.0, tpot=10.0)),
                      prompt))
    return pairs


# ------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_router_matches_jax_router(both_models, n_replicas):
    """prefix-affinity over paged replicas (page_size=16, prefix_block=16),
    each replica on its own ManualClock(auto_step=1e-4): the JAX
    RouterSession and the port's give identical tokens, token_times,
    phases, summary() and event streams."""
    kw = dict(max_len=64, page_size=16)

    async def run(router, pairs):
        async with router:
            return await router.replay(pairs, clients=3)

    jpairs = _shared_head_requests(JaxRequest, JaxSLOSpec)
    tpairs = _shared_head_requests(Request, SLOSpec)
    jtrace, ttrace = JaxTraceRecorder(), TraceRecorder()
    jrouter = JaxRouterSession([_jax_server(both_models, **kw) for _ in range(n_replicas)],
                               policy="prefix-affinity", prefix_block=16, trace=jtrace)
    trouter = RouterSession([_server(both_models, **kw) for _ in range(n_replicas)],
                            policy="prefix-affinity", prefix_block=16, trace=ttrace)
    jout = asyncio.run(run(jrouter, jpairs))
    tout = asyncio.run(run(trouter, tpairs))
    assert tout == jout
    for (jr, _), (tr, _) in zip(jpairs, tpairs, strict=True):
        assert tr.phase.value == jr.phase.value == "done"
        assert tr.token_times == jr.token_times, tr.rid
    ts = trouter.summary()
    assert ts == jrouter.summary()
    assert [e.as_dict() for e in ttrace.events] == [e.as_dict() for e in jtrace.events]
    assert ts["prefix"]["hit_tokens"] > 0
    if n_replicas == 2:
        assert min(ts["routing"]["assigned"]) > 0


# --------------------------------------- twins of tests/test_policies_registry.py
def test_available_policies_enumerates_every_side():
    pol = available_policies()
    assert set(pol) == {"prefill", "decode", "router", "deflection", "autoscaler"}
    assert set(pol["router"]) == {
        "round-robin", "least-queued", "slack-aware", "prefix-affinity",
    }
    assert set(pol["deflection"]) == {
        "never", "short-prompt-threshold", "prefill-pressure", "slack-aware",
    }
    assert set(pol["autoscaler"]) == {"static", "queue-threshold", "slo-attainment-pid"}
    assert pol["prefill"] == available_prefill_policies()
    assert pol["decode"] == available_decode_policies()
    assert pol["router"] == available_router_policies()
    assert pol["deflection"] == available_deflection_policies()
    assert pol["autoscaler"] == available_autoscaler_policies()


def test_every_side_enumerates_as_the_jax_registry():
    from repro.policies import available_policies as jax_available_policies

    assert available_policies() == jax_available_policies()


# ------------------------------------------- twins of tests/test_prefix_router.py
@dataclass
class _FakeReplica:
    in_flight: int = 0
    pending_prefill_tokens: int = 0
    mu: float = 1000.0
    prefixes: List[int] = field(default_factory=list)

    def prefix_match(self, prompt):
        return self.prefixes[0] if self.prefixes else 0


def _req(input_len=8):
    return Request(rid=0, arrival=0.0, input_len=input_len, output_len=4,
                   slo=SLOSpec(ttft=1.0, tpot=1.0))


def test_router_registry_and_round_robin():
    rr = make_router("round-robin")
    reps = [_FakeReplica(), _FakeReplica(), _FakeReplica()]
    assert [rr.select(reps, _req(), []) for _ in range(5)] == [0, 1, 2, 0, 1]
    with pytest.raises(ValueError, match="router"):
        make_router("nope")


def test_least_queued_picks_min_in_flight():
    pol = make_router("least-queued")
    reps = [_FakeReplica(in_flight=3), _FakeReplica(in_flight=1), _FakeReplica(in_flight=2)]
    assert pol.select(reps, _req(), []) == 1
    reps[1].in_flight = 3
    assert pol.select(reps, _req(), []) == 2


def test_slack_aware_uses_backlog_over_throughput():
    pol = make_router("slack-aware")
    reps = [
        _FakeReplica(pending_prefill_tokens=100, mu=100.0),
        _FakeReplica(pending_prefill_tokens=400, mu=1000.0),
    ]
    assert pol.select(reps, _req(input_len=8), []) == 1


def test_prefix_affinity_routes_to_match_else_balances():
    pol = make_router("prefix-affinity")
    reps = [_FakeReplica(in_flight=0, prefixes=[0]), _FakeReplica(in_flight=5, prefixes=[8])]
    assert pol.select(reps, _req(), list(range(8))) == 1
    reps = [_FakeReplica(in_flight=5, prefixes=[0]), _FakeReplica(in_flight=0, prefixes=[0])]
    assert pol.select(reps, _req(), list(range(8))) == 1


def test_cross_replica_cancel_reclaims_owning_replica_only(both_models):
    """A client that disconnects mid-stream from a routed request reclaims
    the decode slot on the owning replica only; the other replica's stream
    runs to completion undisturbed."""
    servers = [_server(both_models) for _ in range(2)]
    (r0, p0), (r1, p1) = _requests(n=2, max_out=6, seed=5)

    async def run():
        router = RouterSession(servers, policy="round-robin")
        async with router:
            h0 = await router.submit(r0, p0)
            h1 = await router.submit(r1, p1)

            async def disconnect_after_first(h):
                async for _ in h.stream():
                    break

            async def drain(h):
                async for _ in h.stream():
                    pass

            await asyncio.gather(disconnect_after_first(h0), drain(h1))
        return router

    router = asyncio.run(run())
    assert router.owner_of(r0.rid) == 0 and router.owner_of(r1.rid) == 1
    assert r0.phase == Phase.CANCELLED and r0.n_generated >= 1
    assert r1.phase == Phase.DONE
    own, other = router.replicas[0].frontend.session, router.replicas[1].frontend.session
    assert own.metrics.cancelled == 1 and other.metrics.cancelled == 0
    assert other.metrics.completed == 1
    for sess, srv in zip((own, other), servers, strict=True):
        assert sess.queue == [] and sess.waiting_adm == [] and sess.active == []
        assert srv.decode.alloc.live_tokens == {}
    s = router.summary()
    assert s["cancelled"] == 1 and s["completed"] == 1
    assert s["routing"]["assigned"] == [1, 1]


def test_single_replica_router_is_bit_identical_to_frontend(both_models):
    """Routing through a 1-replica RouterSession reproduces the bare
    AsyncServeSession replay bit for bit: the router reads no clock."""
    pairs_direct = _requests(n=5, max_out=4, seed=2, arrival_gap=0.01)
    pairs_routed = copy.deepcopy(pairs_direct)

    async def run_direct():
        frontend = AsyncServeSession(_server(both_models))
        async with frontend:
            return await frontend.replay(pairs_direct, clients=3)

    async def run_routed():
        router = RouterSession([_server(both_models)], policy="round-robin")
        async with router:
            return await router.replay(pairs_routed, clients=3)

    assert asyncio.run(run_direct()) == asyncio.run(run_routed())
    for (rd, _), (rr, _) in zip(pairs_direct, pairs_routed, strict=True):
        assert rd.phase == rr.phase == Phase.DONE
        assert rd.token_times == rr.token_times
