"""The moe, vlm and alternating local/global (gemma2) decoders of the port
against ``repro.models`` with the same weights (bridged ``jax.random.key(0)``
f32 smoke parameters): prefill and decode logits within 2e-4, greedy
tokens equal, the model-level softcaps, vlm prefill from embeddings, the
gemma2 ring cache (decode, handoff, shapes) and the weight bridge of the
moe and vlm trees."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import cache_struct as jax_cache_struct  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving.engine import reference_generate as jax_reference_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, cache_struct  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import reference_generate  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["gemma2-9b-smoke", "grok-1-314b-smoke", "phi3.5-moe-42b-a6.6b-smoke",
         "minimax-m2.5-proxy-smoke", "chameleon-34b-smoke"]
_CACHE = {}


def _pair(arch):
    """(jax model, jax params, torch model, torch params), f32, equal weights."""
    if arch not in _CACHE:
        jcfg = jax_get_config(arch).replace(dtype="float32")
        cfg = get_config(arch).replace(dtype="float32")
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _CACHE[arch] = (jm, jp, build_model(cfg), tp)
    return _CACHE[arch]


def _np(t):
    return t.detach().float().numpy()


def _inputs(rng, cfg, b, s):
    """Tokens, or seeded embeddings for input_mode="embeddings" (vlm)."""
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return jnp.asarray(x), torch.from_numpy(x)
    toks = rng.integers(2, cfg.vocab_size, (b, s))
    return jnp.asarray(toks, jnp.int32), torch.tensor(toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, rng):
    """S = 60 right-padded to valid 60 and 41: past gemma2-smoke's window of
    32, so its local layers' window binds."""
    jm, jp, tm, tp = _pair(arch)
    ji, ti = _inputs(rng, tm.cfg, 2, 60)
    valid = np.array([60, 41])
    jl, (jk, jv) = jm.prefill(jp, dict(inputs=ji), jnp.asarray(valid, jnp.int32))
    tl, (tk, tv) = tm.prefill(tp, dict(inputs=ti), torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for t, j in ((tk, jk), (tv, jv)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(_np(t), np.asarray(j), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_prefill_then_decode_match_jax(arch, rng):
    """Two chunks at per-row offsets into a plain 48-row cache, then decode
    steps to position 47: for gemma2-smoke the window of 32 binds in the
    local layers of both (the cache is longer than the window); logits and
    caches within 2e-4."""
    jm, jp, tm, tp = _pair(arch)
    cfg = tm.cfg
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, 2, 48, cfg.num_kv_heads, hd)  # plain k/v even where a ring fits
    jc = dict(k=jnp.zeros(shape, jnp.float32), v=jnp.zeros(shape, jnp.float32))
    tc = dict(k=torch.zeros(shape), v=torch.zeros(shape))
    toks = rng.integers(2, cfg.vocab_size, (2, 48))
    for start, valid, lo in ([0, 0], [16, 11], 0), ([16, 11], [16, 14], 16):
        chunk = toks[:, lo : lo + 16]
        jl, jc = jt.chunk_prefill_step(jp, jnp.asarray(chunk, jnp.int32),
                                       jnp.asarray(start, jnp.int32),
                                       jnp.asarray(valid, jnp.int32), jm.cfg, jc)
        tl, tc = tt.chunk_prefill_step(tp, torch.tensor(chunk), torch.tensor(start),
                                       torch.tensor(valid), cfg, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    pos = np.array([32, 25])
    for _ in range(15):
        a = toks[np.arange(2), pos][:, None]
        jl, jc = jt.decode_step(jp, jnp.asarray(a, jnp.int32), jnp.asarray(pos, jnp.int32),
                                jm.cfg, jc)
        tl, tc = tt.decode_step(tp, torch.tensor(a), torch.tensor(pos), cfg, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", [a for a in ARCHS if not a.startswith("chameleon")])
def test_greedy_tokens_equal_jax_reference(arch, rng):
    """max_len 32 keeps gemma2-smoke on its plain cache (the reference's
    chunk does not fill a ring, ROADMAP C6). chameleon is left out: both
    packages' reference_generate prefill tokens, which its embeddings input
    does not take; its tokens are held by the engine tests."""
    jm, jp, tm, tp = _pair(arch)
    for n in (5, 19):
        prompt = list(map(int, rng.integers(2, tm.cfg.vocab_size, n)))
        assert reference_generate(tm, tp, prompt, 8, 32) == jax_reference_generate(
            jm, jp, prompt, 8, 32)


# ------------------------------------------------------------------- softcaps
@pytest.mark.parametrize("arch", ["gemma2-9b-smoke", "grok-1-314b-smoke"])
def test_softcaps_bind_at_model_level(arch, rng):
    """Weights scaled so that the caps bind (gemma2: attention 50 and final
    30; grok: attention 30): prefill and decode logits equal JAX's, and the
    same weights without the caps give other logits."""
    jm, jp, tm, tp = _pair(arch)
    cfg = tm.cfg
    jp = jax.tree.map(lambda a: a, jp)
    for name in ("wq", "wk"):  # scores of order 100: tanh(s / cap) saturates
        jp["layers"]["attn"][name] = jp["layers"]["attn"][name] * 6.0
    head = "embed" if cfg.tie_embeddings else "lm_head"
    jp[head] = jp[head] * 400.0  # final logits far past 30
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    ji, ti = _inputs(rng, cfg, 2, 20)
    jl, _ = jm.prefill(jp, dict(inputs=ji))
    tl, _ = tm.prefill(tp, dict(inputs=ti))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    if cfg.final_logit_softcap:
        assert np.abs(_np(tl)).max() <= cfg.final_logit_softcap
        assert np.abs(_np(tl)).max() > 0.9 * cfg.final_logit_softcap
    uncapped = cfg.replace(attn_logit_softcap=0.0)
    ul, _ = tt.prefill_step(tp, ti, uncapped)
    assert not np.allclose(_np(ul), _np(tl), **LOGIT_TOL)
    jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24, device="cpu")
    toks = rng.integers(2, cfg.vocab_size, (2, 6))
    for t in range(6):
        a = toks[:, t : t + 1]
        jl, jc = jm.decode(jp, jnp.asarray(a, jnp.int32), jnp.asarray([t, t], jnp.int32), jc)
        tl, tc = tm.decode(tp, torch.tensor(a), torch.tensor([t, t]), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)


# ------------------------------------------------------------------------ vlm
def test_vlm_prefill_from_embeddings_then_decode_on_tokens(rng):
    """chameleon-smoke: the prefill takes (B, S, d_model) embeddings, the
    handoff lands its K/V in a decode cache, and decode continues on tokens
    (the embedding table), as in the reference."""
    jm, jp, tm, tp = _pair("chameleon-34b-smoke")
    cfg = tm.cfg
    ji, ti = _inputs(rng, cfg, 2, 12)
    jl, jkv = jm.prefill(jp, dict(inputs=ji))
    tl, tkv = tm.prefill(tp, dict(inputs=ti))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    tc = tt.handoff(cfg, tkv, tm.init_cache(2, 24, device="cpu"))
    jc = jm.init_cache(2, 24)
    jc = dict(k=jc["k"].at[:, :, :12].set(jkv[0]), v=jc["v"].at[:, :, :12].set(jkv[1]))
    tok = np.asarray(jnp.argmax(jl, -1))
    for t in range(12, 18):
        jl, jc = jm.decode(jp, jnp.asarray(tok[:, None], jnp.int32),
                           jnp.asarray([t, t], jnp.int32), jc)
        tl, tc = tm.decode(tp, torch.tensor(tok[:, None]), torch.tensor([t, t]), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, -1))
        assert (tok == _np(tl).argmax(-1)).all()


# ----------------------------------------------------------------- ring cache
@pytest.mark.parametrize("max_len", [16, 32, 64])
def test_cache_shapes_match_jax(max_len):
    """The ring (k_local/v_local of 32 rows for the L/2 local layers) only
    past the window, as in the reference."""
    js = jax_cache_struct(jax_get_config("gemma2-9b-smoke"), 3, max_len)
    ts = cache_struct(get_config("gemma2-9b-smoke"), 3, max_len)
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
    assert ("k_local" in ts) == (max_len > 32)


def test_ring_decode_matches_jax_ring(rng):
    """tests/test_windowed_cache.py's setup: 60 positions decoded one by one
    into init_cache(1, 64), the ring, in both packages; the port's local
    layers run plain attention over the ring with kv_valid = min(pos + 1, W)."""
    jm, jp, tm, tp = _pair("gemma2-9b-smoke")
    prompt = list(map(int, np.random.default_rng(1).integers(2, tm.cfg.vocab_size, 60)))
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64, device="cpu")
    assert "k_local" in tc and "k_local" in jc
    for t, tok in enumerate(prompt):
        jl, jc = jm.decode(jp, jnp.asarray([[tok]], jnp.int32), jnp.asarray([t], jnp.int32), jc)
        tl, tc = tm.decode(tp, torch.tensor([[tok]]), torch.tensor([t]), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"position {t}",
                                   **LOGIT_TOL)
    for name in ("k", "v", "k_local", "v_local"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_handoff_into_the_ring_equals_decoding_from_zero(impl, rng):
    """Two right-padded prompts (50 and 23 valid tokens, window 32): the
    prefill handed into init_cache(2, 64), the ring, then 12 decode steps
    give the logits and the ring of the same prompts decoded token by token
    from position 0 (the only way the reference fills its ring)."""
    _, _, tm, tp = _pair("gemma2-9b-smoke")
    cfg = tm.cfg.replace(attn_impl=impl)
    lens = [50, 23]
    toks = np.random.default_rng(2).integers(2, cfg.vocab_size, (2, 62))
    toks[1, 23:] = 0
    lg, kv = tt.prefill_step(tp, torch.tensor(toks[:, :50]), cfg,
                             torch.tensor(lens, dtype=torch.int32))
    ring = tt.handoff(cfg, kv, tm.init_cache(2, 64, device="cpu"), valid_len=lens)
    step = tm.init_cache(2, 64, device="cpu")
    for t in range(50):
        pos = torch.tensor([t, min(t, 22)])  # row 1 rewrites its last position
        a = torch.tensor(toks[np.arange(2), pos.numpy()][:, None])
        ls, step = tt.decode_step(tp, a, pos, cfg, step)
        if t == 22:
            ls1 = ls[1]
    np.testing.assert_allclose(_np(lg), np.stack([_np(ls[0]), _np(ls1)]), **LOGIT_TOL)
    for name in ("k_local", "v_local"):
        np.testing.assert_allclose(_np(ring[name]), _np(step[name]), **LOGIT_TOL)
    pos = torch.tensor(lens)
    tok = torch.argmax(lg, -1)
    for _ in range(12):
        lr, ring = tt.decode_step(tp, tok[:, None], pos, cfg, ring)
        ld, step = tt.decode_step(tp, tok[:, None], pos, cfg, step)
        np.testing.assert_allclose(_np(lr), _np(ld), **LOGIT_TOL)
        tok, pos = torch.argmax(lr, -1), pos + 1


def test_chunked_prefill_refuses_the_ring():
    """ROADMAP C6: the reference's chunk fails on a ring cache (its scan
    pairs L layers with L/2 ring rows); the port raises a ValueError that
    names the ring."""
    _, _, tm, tp = _pair("gemma2-9b-smoke")
    cache = tm.init_cache(1, 64, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tt.chunk_prefill_step(tp, torch.zeros(1, 8, dtype=torch.long), [0], [8], tm.cfg, cache)


# ------------------------------------------------------------------ the bridge
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b-smoke", "chameleon-34b-smoke"])
def test_bridge_takes_the_moe_and_vlm_trees(arch):
    jm, jp, tm, tp = _pair(arch)
    assert ("moe" in tp["layers"]) == (tm.cfg.family == "moe")
    assert tp["layers"]["moe" if "moe" in tp["layers"] else "mlp"]["w_up"].shape[0] == \
        tm.cfg.num_layers
    shapes = jax.tree.map(lambda t: tuple(t.shape), tm.init(0, device="cpu"))
    assert shapes == jax.tree.map(lambda a: a.shape, jp)
    if tm.cfg.family == "moe":
        assert tp["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b-smoke", "chameleon-34b-smoke"])
def test_bridge_rejects_a_wrong_layer_axis_or_family(arch):
    jm, jp, tm, _ = _pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    ffn = "moe" if tm.cfg.family == "moe" else "mlp"
    tree["layers"][ffn]["w_up"] = tree["layers"][ffn]["w_up"][:1]  # one layer short
    with pytest.raises(ValueError, match="layer axes"):
        params_from_jax(tree, tm.cfg, device="cpu")
    other = "phi3.5-moe-42b-a6.6b-smoke" if tm.cfg.family != "moe" else "llama3-8b-smoke"
    with pytest.raises(ValueError):
        params_from_jax(jax.tree.map(np.asarray, jp), get_config(other).replace(
            dtype="float32", d_model=tm.cfg.d_model), device="cpu")
