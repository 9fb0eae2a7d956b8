"""Sliding-window and blockwise attention of the port against
``repro.models.layers`` on the same inputs: the window term of the mask,
the windowed naive and blockwise paths at offsets in ``q_pos`` and with
``kv_valid``, the dispatch between them, and the port's rule that a window
which cannot bind (Skv <= window) is dropped so the call takes the
kernels."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _inputs(rng, b=2, sq=6, skv=40, hq=4, hkv=2, d=16, offsets=(0, 30)):
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32) * 2
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    start = np.array(offsets)
    q_pos = (start[:, None] + np.arange(sq)[None]).astype(np.int32)
    kv_valid = (start + sq).astype(np.int32)
    return q, k, v, q_pos, kv_valid


@pytest.mark.parametrize("window", [4, 16])
def test_attention_mask_with_window(window, rng):
    q_pos = rng.integers(0, 30, (3, 5)).astype(np.int32)
    kv_valid = np.array([30, 9, 1], np.int32)
    ref = jl.attention_mask(jnp.asarray(q_pos), 32, jnp.asarray(kv_valid), window=window)
    out = tl.attention_mask(_t(q_pos), 32, _t(kv_valid), window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("impl", ["naive", "blockwise", "auto"])
@pytest.mark.parametrize("offsets", [(0, 30), (17, 3)])
def test_windowed_attention_matches_jax(offsets, impl, cap, rng):
    """A binding window (Skv 40 > 8) on the plain paths, chunks at per-row
    offsets with kv_valid, against the JAX dispatch of the same impl."""
    q, k, v, q_pos, kv_valid = _inputs(rng, offsets=offsets)
    args = [jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)]
    ref = jl.attention(*args, window=8, logit_cap=cap, impl=impl)
    out = tl.attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), window=8, logit_cap=cap,
                       impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_blockwise_attention_over_several_blocks(window, rng):
    """Blockwise with small KV blocks (ragged last block) against JAX's, and
    against the naive path, with and without a window."""
    q, k, v, q_pos, kv_valid = _inputs(rng, sq=7, skv=45, offsets=(5, 38))
    ref = jl.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)),
                                 window, True, 30.0, kv_block=8)
    out = tl.blockwise_attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), window, 30.0,
                                 kv_block=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    mask = tl.attention_mask(_t(q_pos), 45, _t(kv_valid), window)
    naive = tl.naive_attention(_t(q), _t(k), _t(v), mask, 30.0)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), **TOL)


def test_auto_goes_blockwise_above_the_naive_limit(rng, monkeypatch):
    q, k, v, q_pos, kv_valid = _inputs(rng)
    calls = []
    real = tl.blockwise_attention
    monkeypatch.setattr(tl, "blockwise_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tl, "_NAIVE_ATTN_LIMIT", 6 * 40 - 1)
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)), window=8,
                       impl="naive")
    out = tl.attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), window=8)
    assert calls == [1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sq", [1, 6])
@pytest.mark.parametrize("skv", [15, 16, 17])
def test_window_rule_on_both_sides_of_the_cache_length(skv, sq, rng, monkeypatch):
    """window 16: with Skv <= 16 the window cannot bind, is dropped and the
    call takes the kernels' wrappers (impl="pallas", their plain versions on
    the CPU); with Skv = 17 it binds and the call takes the plain path.
    Either way the output equals JAX's windowed naive attention."""
    q, k, v, _, _ = _inputs(rng, sq=sq, skv=skv)
    start = np.array([skv - sq, max(skv - sq - 5, 0)])
    q_pos = (start[:, None] + np.arange(sq)[None]).astype(np.int32)
    kv_valid = (start + sq).astype(np.int32)
    hits = []
    for name in ("prefill_attention", "decode_attention"):
        real = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _r=real, **kw: hits.append(1) or _r(*a, **kw))
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)), window=16,
                       impl="naive")
    out = tl.attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), window=16, impl="pallas")
    assert bool(hits) == (skv <= 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_global_sentinel_never_binds(rng, monkeypatch):
    """gemma2's global layers carry the reference's 2^30 window: the port
    drops it and takes the kernels, equal to unwindowed attention."""
    q, k, v, q_pos, kv_valid = _inputs(rng)
    hits = []
    real = tl.prefill_attention
    monkeypatch.setattr(tl, "prefill_attention", lambda *a, **kw: hits.append(1) or real(*a, **kw))
    out = tl.attention(*(_t(a) for a in (q, k, v, q_pos, kv_valid)), window=1 << 30,
                       impl="pallas")
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)))
    assert hits == [1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
