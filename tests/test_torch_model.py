"""The port's dense decoder against ``repro.models`` with the same weights:
bridged ``llama3-8b-smoke`` f32 parameters, logits within 2e-4 for the
one-shot prefill, chunked prefill and decode under both attention impls,
the KV cache helpers, and the weight bridge itself."""
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
from repro_torch.serving.kvcache import (  # noqa: E402
    gather_pages,
    gather_slots,
    scatter_pages,
    scatter_slots,
)

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config("llama3-8b-smoke").replace(dtype="float32")
    return jax_build_model(cfg).init(jax.random.key(0))


def _pair(jax_params, impl="auto"):
    jcfg = jax_get_config("llama3-8b-smoke").replace(dtype="float32", attn_impl=impl)
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32", attn_impl=impl)
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")
    return jcfg, cfg, tp


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_prefill_step_matches_jax(jax_params, impl, rng):
    jcfg, cfg, tp = _pair(jax_params, impl)
    toks = rng.integers(2, cfg.vocab_size, (2, 12))
    valid = np.array([12, 7])
    jl, (jk, jv) = jt.prefill_step(jax_params, jnp.asarray(toks, jnp.int32), jcfg,
                                   jnp.asarray(valid, jnp.int32))
    tl, (tk, tv) = tt.prefill_step(tp, torch.tensor(toks), cfg,
                                   torch.tensor(valid, dtype=torch.int32))
    assert tl.dtype == torch.float32 and tuple(tk.shape) == jk.shape
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **LOGIT_TOL)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_chunk_prefill_then_decode_match_jax(jax_params, impl, rng):
    """Two chunks at per-row offsets, then three decode steps: logits and
    the caches stay within 2e-4 of the reference."""
    jcfg, cfg, tp = _pair(jax_params, impl)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    toks = rng.integers(2, cfg.vocab_size, (2, 16))
    for start, valid, lo in ([0, 0], [8, 5], 0), ([8, 5], [8, 6], 8):
        chunk = toks[:, lo : lo + 8]
        jl, jc = jt.chunk_prefill_step(
            jax_params, jnp.asarray(chunk, jnp.int32), jnp.asarray(start, jnp.int32),
            jnp.asarray(valid, jnp.int32), jcfg, jc,
        )
        tl, tc = tt.chunk_prefill_step(tp, torch.tensor(chunk), torch.tensor(start),
                                       torch.tensor(valid), cfg, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    pos = np.array([16, 11])
    for step in range(3):
        tok = rng.integers(2, cfg.vocab_size, (2, 1))
        jl, jc = jt.decode_step(jax_params, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos + step, jnp.int32), jcfg, jc)
        tl, tc = tt.decode_step(tp, torch.tensor(tok), torch.tensor(pos + step), cfg, tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **LOGIT_TOL)


def test_greedy_tokens_equal_jax_reference(jax_params, rng):
    jcfg, cfg, tp = _pair(jax_params)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    for n in (5, 23):
        prompt = list(map(int, rng.integers(2, cfg.vocab_size, n)))
        assert reference_generate(tm, tp, prompt, 8, 64) == jax_reference_generate(
            jm, jax_params, prompt, 8, 64
        )


def test_chunk_must_fit_the_cache(jax_params):
    _, cfg, tp = _pair(jax_params)
    cache = build_model(cfg).init_cache(1, 16, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tt.chunk_prefill_step(tp, torch.zeros(1, 8, dtype=torch.long), [12], [5], cfg, cache)


def test_chunk_padding_past_the_cache_end_is_dropped(jax_params, rng):
    """A last chunk whose padding runs past max_len writes its valid rows at
    their true positions (the reference's clamp would shift them back)."""
    _, cfg, tp = _pair(jax_params)
    tm = build_model(cfg)
    toks = rng.integers(2, cfg.vocab_size, (1, 16))
    whole = tm.init_cache(1, 16, device="cpu")
    lw, _ = tt.chunk_prefill_step(tp, torch.tensor(toks[:, :14]), [0], [14], cfg, whole)
    split = tm.init_cache(1, 16, device="cpu")
    tt.chunk_prefill_step(tp, torch.tensor(toks[:, :8]), [0], [8], cfg, split)
    padded = np.concatenate([toks[:, 8:14], np.zeros((1, 2), toks.dtype)], axis=1)
    ls, _ = tt.chunk_prefill_step(tp, torch.tensor(padded), [8], [6], cfg, split)
    np.testing.assert_allclose(_np(ls), _np(lw), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(split[name][:, :, :14]), _np(whole[name][:, :, :14]),
                                   rtol=1e-5, atol=1e-5)


def test_param_and_cache_structure_match_jax(jax_params):
    _, cfg, _ = _pair(jax_params)
    tp = build_model(cfg).init(0, device="cpu")
    jshape = jax.tree.map(lambda a: a.shape, jax_params)
    tshape = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert tshape == jshape
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tp))
    js = jax_cache_struct(jax_get_config("llama3-8b-smoke"), 3, 40)
    ts = cache_struct(get_config("llama3-8b-smoke"), 3, 40)
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
    assert all(v.dtype == torch.bfloat16 and v.device.type == "meta" for v in ts.values())


def test_init_is_seeded(jax_params):
    _, cfg, _ = _pair(jax_params)
    m = build_model(cfg)
    a, b, c = m.init(0, device="cpu"), m.init(0, device="cpu"), m.init(1, device="cpu")
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["lm_head"], c["lm_head"])


def test_bf16_bridge_keeps_the_bits():
    jcfg = jax_get_config("llama3-8b-smoke")
    jp = jax_build_model(jcfg).init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), get_config("llama3-8b-smoke"),
                         device="cpu")
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp), strict=True):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


def test_bridge_rejects_a_foreign_tree(jax_params):
    _, cfg, _ = _pair(jax_params)
    tree = jax.tree.map(np.asarray, jax_params)
    tree.pop("lm_head")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, cfg, device="cpu")


def test_gather_scatter_slots_roundtrip(rng):
    cfg = get_config("llama3-8b-smoke")
    cache = build_model(cfg).init_cache(5, 8, device="cpu")
    idx = torch.tensor([3, 0])
    sub = {n: torch.tensor(rng.standard_normal((leaf.shape[0], 2, *leaf.shape[2:])))
           .to(leaf.dtype) for n, leaf in cache.items()}
    scatter_slots(cfg, cache, sub, idx)
    back = gather_slots(cfg, cache, idx)
    for n in cache:
        assert torch.equal(back[n], sub[n])
        assert not cache[n][:, [1, 2, 4]].any()  # other slots untouched


def test_gather_scatter_pages_roundtrip(rng):
    """The torch twin of tests/test_paged_kv.py::test_gather_scatter_pages_roundtrip."""
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    ps, n_pages = 4, 8
    pool = build_model(cfg).init_cache(n_pages, ps, device="cpu")
    table = torch.tensor([[3, 1, 5], [0, 6, 2]])  # two requests, three pages each
    sub = {n: torch.tensor(rng.standard_normal((leaf.shape[0], 2, 3 * ps, *leaf.shape[3:])),
                           dtype=leaf.dtype) for n, leaf in pool.items()}
    scatter_pages(cfg, pool, sub, table)
    back = gather_pages(cfg, pool, table)
    for n in pool:
        assert torch.equal(back[n], sub[n])
        assert not pool[n][:, [4, 7]].any()
