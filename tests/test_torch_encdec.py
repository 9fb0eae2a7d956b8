"""The encoder-decoder family of the port (``repro_torch.models.encdec``)
against ``repro.models.encdec`` with the same weights (bridged
``jax.random.key(0)`` f32 ``seamless-m4t-medium-smoke`` parameters):
non-causal and packed-segment attention within 2e-5, encode, prefill and
decode within 2e-4, greedy tokens equal, the cache structure, the weight
bridge's checks, the engine's refusal and the C7 pin.

The reference's encdec passes the default ``impl="auto"`` to every
attention call, so under ``attn_impl="pallas"`` the JAX side stays on its
plain paths, while the port's causal self attention and one-query cross
attention take the kernels' wrappers (their plain versions on CPU
tensors): the same function by two routes."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import cache_struct as jax_cache_struct  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, cache_struct  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig  # noqa: E402

ARCH = "seamless-m4t-medium-smoke"
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
S_SRC, S_TGT, MAX_LEN = 12, 8, 24
SRC_VALID, TGT_VALID = np.array([12, 7], np.int32), np.array([8, 5], np.int32)
_CACHE = {}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _pair(impl="auto"):
    """(jax model, jax params, torch model, torch params), f32, equal weights."""
    if impl not in _CACHE:
        jcfg = jax_get_config(ARCH).replace(dtype="float32", attn_impl=impl)
        cfg = get_config(ARCH).replace(dtype="float32", attn_impl=impl)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        _CACHE[impl] = (jm, jp, build_model(cfg), tp)
    return _CACHE[impl]


def _inputs(rng, cfg, b=2):
    src = rng.standard_normal((b, S_SRC, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(2, cfg.vocab_size, (b, S_TGT)).astype(np.int32)
    return src, tgt


def _qkv(rng, b, sq, skv, hq, hkv, d=16):
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("impl", ["auto", "blockwise", "blockwise-8"])
def test_non_causal_attention_matches_jax(impl, rng):
    """Non-causal with a ragged kv_valid: the naive path, the blockwise path
    (one block), and blockwise over several 8-row blocks (ragged last)."""
    b, sq, skv = 2, 6, 21
    q, k, v = _qkv(rng, b, sq, skv, 4, 2)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    kv_valid = np.array([21, 9], np.int32)
    if impl == "blockwise-8":
        ref = jl.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)),
                                     0, False, 0.0, kv_block=8)
        out = tl.blockwise_attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), 0, 0.0,
                                     kv_block=8, causal=False)
    else:
        ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)), causal=False,
                           impl=impl)
        out = tl.attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), causal=False, impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
@pytest.mark.parametrize("segs", ["both", "q-only"])
def test_packed_segments_match_jax(segs, causal, impl, rng):
    """Packed segments force the naive path under every impl; the segment
    test applies only when both q_seg and kv_seg are given."""
    b, s = 2, 10
    q, k, v = _qkv(rng, b, s, s, 4, 2)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    seg = np.array([[0] * 4 + [1] * 6, [0] * 7 + [1] * 3], np.int32)
    kv_valid = np.array([10, 8], np.int32)
    kw_j = dict(q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg) if segs == "both" else None)
    kw_t = dict(q_seg=_t(seg), kv_seg=_t(seg) if segs == "both" else None)
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, pos, kv_valid)), causal=causal,
                       impl=impl, **kw_j)
    out = tl.attention(*(_t(a) for a in (q, k, v, pos, kv_valid)), causal=causal, impl=impl,
                       **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    mask = tl.attention_mask(_t(pos), s, _t(kv_valid), 0, causal, **kw_t)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jl.attention_mask(jnp.asarray(pos), s, jnp.asarray(kv_valid),
                                                   0, causal, **kw_j)))


@pytest.mark.parametrize("kv_valid", [None, [13, 4]], ids=["all-rows", "kv-valid"])
def test_one_query_non_causal_takes_the_decode_wrapper(kv_valid, rng, monkeypatch):
    """Sq == 1, non-causal, impl="pallas": the port's route to the decode
    kernel's wrapper (its plain version on the CPU) with kv_len = kv_valid
    (Skv where None), against JAX's naive path."""
    calls = []
    real = tl.decode_attention
    monkeypatch.setattr(tl, "decode_attention",
                        lambda q, k, v, kv_len, **kw: calls.append(kv_len.tolist())
                        or real(q, k, v, kv_len, **kw))
    q, k, v = _qkv(rng, 2, 1, 13, 4, 4)
    q_pos = np.array([[3], [0]], np.int32)
    jv = None if kv_valid is None else jnp.asarray(kv_valid, jnp.int32)
    tv = None if kv_valid is None else torch.tensor(kv_valid, dtype=torch.int32)
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos)), jv, causal=False,
                       impl="naive")
    out = tl.attention(*(_t(a) for a in (q, k, v, q_pos)), tv, causal=False, impl="pallas")
    assert calls == [kv_valid or [13, 13]]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


# ---------------------------------------------------------------------- model

@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged-src"])
def test_encode_matches_jax(ragged, rng):
    jm, jp, tm, tp = _pair()
    src, _ = _inputs(rng, tm.cfg)
    sv = SRC_VALID if ragged else None
    ref = je.encode(jp, jnp.asarray(src), jm.cfg, None if sv is None else jnp.asarray(sv))
    out = te.encode(tp, _t(src), tm.cfg, None if sv is None else _t(sv))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_prefill_matches_jax(impl, rng):
    """Logits and every cache leaf, ragged source and target."""
    jm, jp, tm, tp = _pair(impl)
    src, tgt = _inputs(rng, tm.cfg)
    jl_, jkv = je.prefill_step(jp, jnp.asarray(src), jnp.asarray(tgt), jm.cfg,
                               jnp.asarray(SRC_VALID), jnp.asarray(TGT_VALID))
    tl_, tkv = te.prefill_step(tp, _t(src), _t(tgt), tm.cfg, _t(SRC_VALID), _t(TGT_VALID))
    np.testing.assert_allclose(_np(tl_), np.asarray(jl_), **TOL)
    assert set(tkv) == set(jkv)
    for name in jkv:
        assert tuple(tkv[name].shape) == jkv[name].shape, name
        np.testing.assert_allclose(_np(tkv[name]), np.asarray(jkv[name]), **TOL)


def _jax_cache(jkv, max_len):
    """The reference's counterpart of `handoff`: self K/V in the first rows
    of a max_len self cache, the cross leaves as the prefill gave them."""
    out = dict(jkv)
    for name in ("self_k", "self_v"):
        x = jkv[name]
        pad = jnp.zeros((*x.shape[:2], max_len, *x.shape[3:]), x.dtype)
        out[name] = pad.at[:, :, : x.shape[2]].set(x)
    return out


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("enc_valid", [False, True], ids=["no-enc-valid", "enc-valid"])
def test_decode_after_handoff_matches_jax(enc_valid, impl, rng):
    """One decode step on a handoff-built cache (with and without
    enc_valid), then 8 greedy steps: logits within 2e-4 at every step,
    tokens equal. Positions stay below max_len (the reference's select
    writes nothing past it)."""
    jm, jp, tm, tp = _pair(impl)
    src, tgt = _inputs(rng, tm.cfg)
    sv = SRC_VALID if enc_valid else None
    jlg, jkv = je.prefill_step(jp, jnp.asarray(src), jnp.asarray(tgt), jm.cfg,
                               None if sv is None else jnp.asarray(sv), jnp.asarray(TGT_VALID))
    tlg, tkv = te.prefill_step(tp, _t(src), _t(tgt), tm.cfg, None if sv is None else _t(sv),
                               _t(TGT_VALID))
    jc = _jax_cache(jkv, MAX_LEN)
    tc = te.handoff(tm.cfg, tkv, MAX_LEN)
    assert tc["cross_k"].shape[2] == S_SRC and tc["self_k"].shape[2] == MAX_LEN
    jtok, ttok = jnp.argmax(jlg, -1), torch.argmax(tlg, -1)
    pos = TGT_VALID.copy()
    jtoks, ttoks = [], []
    for _ in range(8):
        jlg, jc = je.decode_step(jp, jtok[:, None], jnp.asarray(pos), jm.cfg, jc,
                                 None if sv is None else jnp.asarray(sv))
        tlg, tc = te.decode_step(tp, ttok[:, None], _t(pos), tm.cfg, tc,
                                 None if sv is None else _t(sv))
        np.testing.assert_allclose(_np(tlg), np.asarray(jlg), **TOL)
        jtok, ttok = jnp.argmax(jlg, -1), torch.argmax(tlg, -1)
        jtoks.append(np.asarray(jtok).tolist())
        ttoks.append(ttok.tolist())
        pos = pos + 1
    assert ttoks == jtoks
    np.testing.assert_allclose(_np(tc["self_k"]), np.asarray(jc["self_k"]), **TOL)


def test_handoff_into_a_given_cache_keeps_the_encoder_length(rng):
    jm, jp, tm, tp = _pair()
    src, tgt = _inputs(rng, tm.cfg)
    _, kv = tm.prefill(tp, dict(src=_t(src), tgt=_t(tgt)))
    cache = tm.init_cache(2, MAX_LEN, device="cpu")
    assert cache["cross_k"].shape[2] == te.DECODE_ENC_LEN
    out = te.handoff(tm.cfg, kv, cache)
    assert out is cache and out["cross_k"] is kv["cross_k"]
    torch.testing.assert_close(out["self_v"][:, :, :S_TGT], kv["self_v"], rtol=0, atol=0)
    assert not out["self_v"][:, :, S_TGT:].any()
    with pytest.raises(ValueError, match="does not fit"):
        te.handoff(tm.cfg, kv, S_TGT - 1)


@pytest.mark.parametrize("batch,max_len", [(1, 16), (3, 40)])
def test_cache_structure_matches_jax(batch, max_len):
    cfg = get_config(ARCH)
    ref = jax_cache_struct(jax_get_config(ARCH), batch, max_len)
    out = cache_struct(cfg, batch, max_len)
    assert set(out) == set(ref)
    for name, sd in ref.items():
        assert tuple(out[name].shape) == sd.shape and str(out[name].dtype) == f"torch.{sd.dtype}"
    assert out["cross_k"].shape[2] == te.DECODE_ENC_LEN == je.DECODE_ENC_LEN
    cache = build_model(cfg.replace(dtype="float32")).init_cache(batch, max_len, device="cpu")
    assert {n: tuple(t.shape) for n, t in cache.items()} == {n: sd.shape for n, sd in ref.items()}


@pytest.mark.parametrize("fault", ["key", "enc-axis", "dec-axis", "cross-subtree"])
def test_params_from_jax_refuses_a_wrong_tree(fault):
    jm, jp, tm, _ = _pair()
    tree = jax.tree.map(np.asarray, jp)
    if fault == "key":
        tree["layers"] = tree.pop("dec_layers")
    elif fault == "enc-axis":
        tree["enc_layers"]["mlp"]["w_up"] = tree["enc_layers"]["mlp"]["w_up"][:1]
    elif fault == "dec-axis":
        tree["dec_layers"]["pre_cross_norm"] = tree["dec_layers"]["pre_cross_norm"][None]
    else:
        del tree["dec_layers"]["cross_attn"]["wv"]
    with pytest.raises(ValueError):
        params_from_jax(tree, tm.cfg, device="cpu")


def test_model_api_matches_jax(rng):
    """Model.prefill (batch["src"], batch["tgt"], valid_len as tgt_valid),
    Model.decode and Model.forward_train dispatch to the family."""
    jm, jp, tm, tp = _pair()
    src, tgt = _inputs(rng, tm.cfg)
    jlg, jkv = jm.prefill(jp, dict(src=jnp.asarray(src), tgt=jnp.asarray(tgt)),
                          jnp.asarray(TGT_VALID))
    tlg, tkv = tm.prefill(tp, dict(src=_t(src), tgt=_t(tgt)), _t(TGT_VALID))
    np.testing.assert_allclose(_np(tlg), np.asarray(jlg), **TOL)
    tok = np.asarray(jnp.argmax(jlg, -1))[:, None]
    jl2, _ = jm.decode(jp, jnp.asarray(tok), jnp.asarray(TGT_VALID), _jax_cache(jkv, MAX_LEN))
    tl2, _ = tm.decode(tp, _t(tok), _t(TGT_VALID), te.handoff(tm.cfg, tkv, MAX_LEN))
    np.testing.assert_allclose(_np(tl2), np.asarray(jl2), **TOL)
    # the training forward (ported with the training slice): teacher-forced logits
    jlt = jm.forward_train(jp, dict(src=jnp.asarray(src), tgt=jnp.asarray(tgt)))
    tlt = tm.forward_train(tp, dict(src=_t(src), tgt=_t(tgt)))
    assert tlt.shape == jlt.shape
    np.testing.assert_allclose(_np(tlt), np.asarray(jlt), **TOL)


def test_c7_padded_cross_cache_pinned(rng):
    """ROADMAP C7, the reference's behaviour kept: Model.decode passes no
    enc_valid, so on init_cache's DECODE_ENC_LEN-row cross leaves it attends
    over the zero rows past the encoder's output. The port equals JAX on
    that cache, and both differ from the exact-length handoff by more than
    1e-2."""
    jm, jp, tm, tp = _pair()
    src, tgt = _inputs(rng, tm.cfg, b=1)
    jlg, jkv = jm.prefill(jp, dict(src=jnp.asarray(src), tgt=jnp.asarray(tgt)))
    tlg, tkv = tm.prefill(tp, dict(src=_t(src), tgt=_t(tgt)))
    padded_j = jm.init_cache(1, MAX_LEN)
    padded_j = {n: x.at[:, :, : jkv[n].shape[2]].set(jkv[n]) for n, x in padded_j.items()}
    padded_t = tm.init_cache(1, MAX_LEN, device="cpu")
    for n, x in padded_t.items():
        x[:, :, : tkv[n].shape[2]].copy_(tkv[n])
    tok = np.asarray(jnp.argmax(jlg, -1))[:, None]
    pos = np.array([S_TGT], np.int32)
    jl2, _ = jm.decode(jp, jnp.asarray(tok), jnp.asarray(pos), padded_j)
    tl2, _ = tm.decode(tp, _t(tok), _t(pos), padded_t)
    np.testing.assert_allclose(_np(tl2), np.asarray(jl2), **TOL)
    exact, _ = tm.decode(tp, _t(tok), _t(pos), te.handoff(tm.cfg, tkv, MAX_LEN))
    assert float((tl2 - exact).abs().max()) > 1e-2


def test_engine_refuses_an_encoder_decoder_model():
    _, _, tm, tp = _pair()
    with pytest.raises(ValueError, match="engine-scope"):
        DisaggServer(tm, tp, EngineConfig(max_slots=2, max_len=32), device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model = build_model(get_config(ARCH).replace(dtype="float32"))
    for call in (lambda: model.init(0), lambda: model.init_cache(1, 8),
                 lambda: te.init_params(model.cfg, 0)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    params = model.init(0, device="cpu")
    assert params["enc_layers"]["attn"]["wq"].shape[0] == model.cfg.enc_layers
