"""The port's serving engine and session on bridged ``llama3-8b-smoke`` f32
weights: torch twins of tests/test_engine_serve.py and the paged-KV parity
tests, the slice as a whole against the JAX ``DisaggServer`` on a
ManualClock, and the pin of ROADMAP C1 (chunk writes at true positions)."""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.request import Request as JaxRequest  # noqa: E402
from repro.core.request import SLOSpec as JaxSLOSpec  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.clock import ManualClock as JaxManualClock  # noqa: E402
from repro.serving.engine import DisaggServer as JaxDisaggServer  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.engine import reference_generate as jax_reference_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.clock import ManualClock  # noqa: E402
import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch.models.transformer import decode_step  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    DisaggServer,
    EngineConfig,
    LiveRequest,
    _bucket,
    reference_generate,
)
from repro_torch.serving.kvcache import SlotAllocator, gather_pages, scatter_pages  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402


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
    ecfg = dict(max_slots=4, max_len=64, chunk_size=16)
    ecfg.update(kw)
    return DisaggServer(model, params, EngineConfig(**ecfg),
                        clock=clock if clock is not None else ManualClock(auto_step=1e-4),
                        device="cpu")


def _prompts(n, seed, lo=4, hi=28):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, 256, rng.integers(lo, hi)))) for _ in range(n)]


def _requests(prompts, max_out, gap=0.002, req_cls=Request, slo_cls=SLOSpec):
    return [
        (req_cls(rid=i, arrival=gap * i, input_len=len(p), output_len=max_out,
                 slo=slo_cls(ttft=120.0, tpot=10.0)), p)
        for i, p in enumerate(prompts)
    ]


def _run_session(server, reqs):
    session = ServeSession(server)
    for req, prompt in reqs:
        session.submit(req, prompt)
    while session.has_work:
        session.step()
    return session


# ------------------------------------------------- tests/test_engine_serve.py
@pytest.mark.parametrize("policy", ["kairos-urgency", "fcfs"])
@pytest.mark.parametrize("decode_policy", ["kairos-slack", "continuous"])
def test_scheduling_invariance(both_models, policy, decode_policy):
    """Scheduling policy changes TIMING, never TOKENS."""
    _, _, model, params = both_models
    prompts = _prompts(4, seed=0)
    reqs = _requests(prompts, max_out=8)
    server = DisaggServer(model, params, EngineConfig(
        max_slots=8, max_len=96, chunk_size=16,
        prefill_policy=policy, decode_policy=decode_policy,
    ), device="cpu")
    outs = server.serve(reqs)
    for i, p in enumerate(prompts):
        ref = reference_generate(model, params, p, 8, 96)
        assert outs[i][: len(ref)] == ref, f"rid={i} policy={policy}/{decode_policy}"
    for r, _ in reqs:
        assert r.phase == Phase.DONE
        assert r.ttft() is not None and r.mean_tpot() is not None


def test_engine_chunked_prefill_spans_chunks(both_models):
    _, _, model, params = both_models
    prompt = _prompts(1, seed=3, lo=45, hi=46)[0]  # 45 > 16 * 2
    req = Request(rid=0, arrival=0.0, input_len=45, output_len=6,
                  slo=SLOSpec(ttft=120.0, tpot=10.0))
    server = _server(both_models, max_len=96)
    outs = server.serve([(req, prompt)])
    assert outs[0] == reference_generate(model, params, prompt, 6, 96)


def test_admission_respects_kv_budget():
    alloc = SlotAllocator(max_slots=4, kv_cap_tokens=100)
    s1 = alloc.alloc(60)
    assert s1 is not None and alloc.alloc(50) is None  # over budget
    assert alloc.alloc(40) is not None and alloc.used_tokens == 100
    alloc.release(s1)
    assert alloc.used_tokens == 40


def test_engine_lut_learns_step_times(both_models):
    server = _server(both_models, max_len=96, chunk_size=32)
    before = server.lut.count.sum()
    server.serve(_requests(_prompts(3, seed=1), max_out=6))
    assert server.lut.count.sum() > before
    assert server.mu._n > 0


# ---------------------------------------------------------- tests/test_paged_kv.py
def test_paged_engine_bit_identical_to_slot_engine_prefix_free(both_models):
    """Torch twin of test_paged_kv.py:195: token ids AND the ManualClock
    latency metrics, per request."""
    reqs_a = _requests(_prompts(5, seed=3, hi=14), max_out=4)
    reqs_b = copy.deepcopy(reqs_a)
    slot = _run_session(_server(both_models), reqs_a)
    paged = _run_session(_server(both_models, page_size=4), reqs_b)
    assert paged.outputs == slot.outputs
    per_s = {d["rid"]: d for d in slot.summary()["requests"]}
    per_p = {d["rid"]: d for d in paged.summary()["requests"]}
    assert per_p.keys() == per_s.keys()
    for rid in per_s:
        assert per_p[rid]["ttft"] == per_s[rid]["ttft"]
        assert per_p[rid]["mean_tpot"] == per_s[rid]["mean_tpot"]
    s = paged.summary()
    assert s["prefix_cached_tokens"] == 0 and s["pages"]["shared_links"] == 0


def test_padded_subbatch_never_corrupts_a_live_slot(both_models):
    """Torch twin of test_paged_kv.py:218: with every slot live, pad lanes of
    a sub-batch smaller than its bucket write the scratch lane/page only."""
    _, _, model, params = both_models
    rng = np.random.default_rng(42)
    prompts = [list(map(int, rng.integers(2, 256, n))) for n in (12, 8, 12, 10)]
    reqs = [(Request(rid=i, arrival=0.0, input_len=len(p), output_len=4,
                     slo=SLOSpec(ttft=120.0, tpot=10.0)), p) for i, p in enumerate(prompts)]
    slot = _run_session(_server(both_models), copy.deepcopy(reqs))
    paged = _run_session(_server(both_models, page_size=4), copy.deepcopy(reqs))
    for i, p in enumerate(prompts):
        ref = reference_generate(model, params, p, 4, 64)
        assert slot.outputs[i] == ref
        assert paged.outputs[i] == ref


def test_paged_prefix_reuse_skips_exactly_the_hit_tokens(both_models):
    """Prefix-heavy prompts on a paged engine: prefill computes prompt
    tokens minus the cached ones, and tokens equal the slot engine's."""
    rng = np.random.default_rng(4)
    head = list(map(int, rng.integers(2, 256, 16)))
    prompts = [head + list(map(int, rng.integers(2, 256, int(rng.integers(4, 14)))))
               for _ in range(4)]
    reqs = _requests(prompts, max_out=3)

    def staggered(server, reqs):
        session = ServeSession(server)
        for req, prompt in reqs:
            session.submit(req, prompt)
            while session.has_work:
                session.step()
        return session

    slot = staggered(_server(both_models), copy.deepcopy(reqs))
    paged = staggered(_server(both_models, page_size=4), copy.deepcopy(reqs))
    s = paged.summary()
    assert s["prefix_cached_tokens"] > 0
    assert s["prefill_computed_tokens"] == sum(map(len, prompts)) - s["prefix_cached_tokens"]
    assert paged.outputs == slot.outputs


# --------------------------------------------------- the paged decode write-back
def _noisy_paged_engine(both_models):
    """The decode engine of a paged server (page 4, max_len 64: 16 pages a
    lane, 64 pages and the scratch page) whose pool holds seeded noise."""
    dec = _server(both_models, page_size=4).decode
    gen = torch.Generator().manual_seed(0)
    for leaf in dec.pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype))
    return dec


def _lanes(lanes):
    """Live requests decoding at ``pos`` with page table ``table``."""
    rng = np.random.default_rng(5)
    return [LiveRequest(req=Request(rid=i, arrival=0.0, input_len=pos + 1, output_len=4),
                        tokens=list(map(int, rng.integers(2, 256, pos + 1))), page_table=table)
            for i, (table, pos) in enumerate(lanes)]


WRITE_BACK_CASES = {
    "first row of a page": [([5, 9, 2], 8)],
    "last row of a page": [([5, 9, 2], 7), ([40, 41], 3)],
    "last page of max_len": [(list(range(16, 32)), 63), (list(range(32, 48)), 60)],
    "shared prefix pages": [([3, 4, 10], 9), ([3, 4, 11], 11)],
    "pad lanes on the scratch page": [([5, 9, 2], 10), ([6], 0), ([7, 8], 4)],
}


@pytest.mark.parametrize("case", sorted(WRITE_BACK_CASES))
def test_paged_step_leaves_the_pool_as_the_whole_lane_write_back(both_models, case):
    """After one paged step every page but the scratch page is bit-identical
    to a pool advanced by gathering each lane's whole table, decoding and
    scattering every page back, and the step samples that decode's tokens."""
    dec = _noisy_paged_engine(both_models)
    batch = _lanes(WRITE_BACK_CASES[case])
    cfg, sp, p = dec.model.cfg, dec.scratch_page, dec.pages_per_req
    bs = _bucket(len(batch), dec.ecfg.decode_buckets)
    rows = [lr.page_table + [sp] * (p - len(lr.page_table)) for lr in batch]
    page_idx = torch.tensor(rows + [[sp] * p] * (bs - len(batch)))
    pos = torch.tensor([lr.req.seq_len - 1 for lr in batch] + [0] * (bs - len(batch)),
                       dtype=torch.int32)
    toks = torch.tensor([lr.tokens[-1] for lr in batch] + [0] * (bs - len(batch)))[:, None]
    want = {n: leaf.clone() for n, leaf in dec.pool.items()}
    logits, sub = decode_step(dec.params, toks, pos, cfg, gather_pages(cfg, want, page_idx))
    scatter_pages(cfg, want, sub, page_idx)

    out = dec.step(batch, None)
    assert out.tolist() == logits.argmax(-1)[: len(batch)].tolist()
    for n in want:
        assert torch.equal(dec.pool[n][:, :sp], want[n][:, :sp]), n


def test_paged_step_writes_back_one_row_a_lane(both_models, monkeypatch):
    """A paged step calls `scatter_pages` once: a (bucket, 1) index into a
    one-row-a-page view of the pool (the pool's own storage), one row a lane."""
    dec = _noisy_paged_engine(both_models)
    calls = []
    real = engine_mod.scatter_pages
    monkeypatch.setattr(engine_mod, "scatter_pages", lambda *a: calls.append(a) or real(*a))
    dec.step(_lanes(WRITE_BACK_CASES["pad lanes on the scratch page"]), None)
    ((_, pool, sub, idx),) = calls
    assert idx.shape == (4, 1)
    for n, leaf in dec.pool.items():
        assert pool[n].shape == (leaf.shape[0], leaf.shape[1] * leaf.shape[2], 1, *leaf.shape[3:])
        assert pool[n].data_ptr() == leaf.data_ptr()
        assert sub[n].shape == (leaf.shape[0], 4, 1, *leaf.shape[3:])


def test_paged_serve_with_the_write_back_left_out_gives_other_tokens(both_models, monkeypatch):
    """The port's side of the benchmark's "state unchanged" fault: with
    `scatter_pages` a no-op the served tokens differ from a sound serve's."""
    reqs = _requests(_prompts(4, seed=6), max_out=8)
    sound = _run_session(_server(both_models, page_size=4), copy.deepcopy(reqs))
    monkeypatch.setattr(engine_mod, "scatter_pages", lambda cfg, pool, sub, idx: pool)
    broken = _run_session(_server(both_models, page_size=4), copy.deepcopy(reqs))
    assert broken.outputs.keys() == sound.outputs.keys()
    assert broken.outputs != sound.outputs


# ------------------------------------------------------------------- ROADMAP C1
def test_chunks_written_at_true_positions_near_max_len(both_models):
    """ROADMAP C1: at max_len=32, chunk_size=16 with prompts of 10 and 28
    tokens at once, the JAX engine clamps a chunk's write and gives rid 1
    [13, 2, 134] where its reference_generate gives [104, 22, 176]. The port
    writes chunks at their true positions, so its engine equals its
    reference on the same repro."""
    jm, jp, model, params = both_models
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(2, 256, n))) for n in (10, 28)]
    kw = dict(max_slots=4, max_len=32, chunk_size=16, prefill_policy="fcfs",
              decode_policy="continuous")
    outs = DisaggServer(model, params, EngineConfig(**kw), clock=ManualClock(auto_step=1e-3),
                        device="cpu").serve(_requests(prompts, max_out=3, gap=0.0))
    for i, p in enumerate(prompts):
        assert outs[i] == reference_generate(model, params, p, 3, 32)
    assert outs[1] == [104, 22, 176]
    jax_outs = JaxDisaggServer(jm, jp, JaxEngineConfig(**kw),
                               clock=JaxManualClock(auto_step=1e-3)).serve(
        _requests(prompts, max_out=3, gap=0.0, req_cls=JaxRequest, slo_cls=JaxSLOSpec))
    assert jax_outs[1] == [13, 2, 134]  # the reference's fault, as recorded
    assert jax_reference_generate(jm, jp, prompts[1], 3, 32) == [104, 22, 176]


# --------------------------------------------------------- the slice as a whole
@pytest.mark.parametrize(
    "prefill_policy,decode_policy",
    [("kairos-urgency", "kairos-slack"), ("fcfs", "continuous")],
)
def test_slice_matches_jax_server_on_manual_clock(both_models, prefill_policy, decode_policy):
    """The JAX DisaggServer and the port's, on a ManualClock with the same
    requests: identical tokens and identical per-request token_times. The
    requests keep start + chunk_size <= max_len (ROADMAP C1)."""
    jm, jp, model, params = both_models
    prompts = _prompts(5, seed=0)
    kw = dict(max_slots=4, max_len=64, chunk_size=16, prefill_policy=prefill_policy,
              decode_policy=decode_policy)
    jreqs = _requests(prompts, 6, req_cls=JaxRequest, slo_cls=JaxSLOSpec)
    treqs = _requests(prompts, 6)
    jout = JaxDisaggServer(jm, jp, JaxEngineConfig(**kw),
                           clock=JaxManualClock(auto_step=1e-3)).serve(jreqs)
    tout = DisaggServer(model, params, EngineConfig(**kw), clock=ManualClock(auto_step=1e-3),
                        device="cpu").serve(treqs)
    assert tout == jout
    for (jr, _), (tr, _) in zip(jreqs, treqs, strict=True):
        assert tr.token_times == jr.token_times, f"rid={tr.rid}"
        assert tr.phase.value == jr.phase.value == "done"


# ------------------------------------------------------------------ launchers
def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "3", "--max-out", "4", "--dtype", "float32"])
    out = capsys.readouterr().out
    assert out.count("phase=done tokens=4") == 3
    assert "E2E SLO attainment" in out and "on cpu" in out


def test_profile_script_runs_on_cpu(capsys):
    """The profiler script's rehearsal path: the smoke serve at smoke size."""
    from repro_torch.launch import profile

    profile.main(["--device", "cpu", "--arch", "llama3-8b-smoke", "--page-size", "64"])
    out = capsys.readouterr().out
    assert "paged KV, 8 requests x 32 tokens on cpu" in out
    assert "host decode_step" in out and "host prefill_chunk" in out
    assert "device decode_step" in out and "device prefill_chunk" in out
