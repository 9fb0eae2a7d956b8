"""The port's engine on the moe, vlm and gemma2 families against the JAX
``DisaggServer``, on ManualClocks with bridged ``jax.random.key(0)`` f32
smoke weights: identical tokens, token times (so TTFT and TPOT) and
obs event streams, slot and paged. gemma2 serves at ``max_len <=
sliding_window``; above it the port refuses to build the engine (the pin
of ROADMAP C6)."""
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs.events import TraceRecorder  # noqa: E402
from repro_torch.serving.clock import ManualClock  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402

ARCHS = ["phi3.5-moe-42b-a6.6b-smoke", "chameleon-34b-smoke", "gemma2-9b-smoke",
         "grok-1-314b-smoke"]
_CACHE = {}


def _pair(arch):
    if arch not in _CACHE:
        jcfg = jax_get_config(arch).replace(dtype="float32")
        cfg = get_config(arch).replace(dtype="float32")
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _CACHE[arch] = (jm, jp, build_model(cfg), tp)
    return _CACHE[arch]


def _requests(prompts, max_out, req_cls, slo_cls, gap=0.002):
    return [
        (req_cls(rid=i, arrival=gap * i, input_len=len(p), output_len=max_out,
                 slo=slo_cls(ttft=120.0, tpot=10.0)), p)
        for i, p in enumerate(prompts)
    ]


@pytest.mark.parametrize("page_size", [None, 8], ids=["slot", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_server_on_manual_clock(arch, page_size):
    """max_len 32 (gemma2-smoke's window: its plain cache), chunks of 8 with
    start + chunk_size <= max_len (ROADMAP C1); 5 requests, 6 tokens each,
    under kairos-urgency / kairos-slack."""
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, tm.cfg.vocab_size, rng.integers(4, 21))))
               for _ in range(5)]
    kw = dict(max_slots=4, max_len=32, chunk_size=8, page_size=page_size)
    jreqs = _requests(prompts, 6, JaxRequest, JaxSLOSpec)
    treqs = _requests(prompts, 6, Request, SLOSpec)
    jtrace, ttrace = JaxTraceRecorder(), TraceRecorder()
    jout = JaxDisaggServer(jm, jp, JaxEngineConfig(**kw), clock=JaxManualClock(auto_step=1e-3),
                           trace=jtrace).serve(jreqs)
    tserver = DisaggServer(tm, tp, EngineConfig(**kw), clock=ManualClock(auto_step=1e-3),
                           trace=ttrace, device="cpu")
    tout = tserver.serve(treqs)
    assert tout == jout
    for (jr, _), (tr, _) in zip(jreqs, treqs, strict=True):
        assert tr.phase.value == jr.phase.value == "done"
        assert tr.token_times == jr.token_times, f"rid={tr.rid}"
        assert (tr.ttft(), tr.mean_tpot()) == (jr.ttft(), jr.mean_tpot())
    assert [e.as_dict() for e in ttrace.events] == [e.as_dict() for e in jtrace.events]


@pytest.mark.parametrize("page_size", [None, 8], ids=["slot", "paged"])
def test_engine_refuses_a_ring_cache(page_size):
    """ROADMAP C6: past the window (64 > 32) the decode cache would be the
    ring, which chunked prefill does not fill; the port's engine raises at
    construction with an error naming it (this asserts only the port)."""
    _, _, tm, tp = _pair("gemma2-9b-smoke")
    with pytest.raises(ValueError, match="ring cache"):
        DisaggServer(tm, tp, EngineConfig(max_slots=2, max_len=64, chunk_size=8,
                                          page_size=page_size), device="cpu")
    DisaggServer(tm, tp, EngineConfig(max_slots=2, max_len=32, chunk_size=8,
                                      page_size=page_size), device="cpu")
