"""Every layer of the port against its twin in ``repro.models.layers`` on
the same random inputs (made with numpy), plus the sampler, the device
rule and the slices' NotImplementedError boundary (windowed and blockwise
attention are held against JAX in tests/test_torch_window.py, non-causal
and packed-segment attention in tests/test_torch_encdec.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.serving.sampler import sample as jax_sample  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving.sampler import sample  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w), 1e-6).numpy(), np.asarray(ref), **TOL)


def test_rms_norm_keeps_bf16_and_scales_by_one_plus_weight(rng):
    x = torch.tensor(rng.standard_normal((3, 16)), dtype=torch.bfloat16)
    out = tl.rms_norm(x, torch.zeros(16, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    rms = x.float().pow(2).mean(-1, keepdim=True).add(1e-6).rsqrt()
    torch.testing.assert_close(out.float(), (x.float() * rms).bfloat16().float())


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta, rng):
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    ref = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(tl.rope(_t(x), _t(pos), theta).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap, rng):
    x = (rng.standard_normal((4, 9)) * 40).astype(np.float32)
    ref = jl.softcap(jnp.asarray(x), cap)
    np.testing.assert_allclose(tl.softcap(_t(x), cap).numpy(), np.asarray(ref), **TOL)


def test_attention_mask(rng):
    q_pos = rng.integers(0, 20, (3, 5)).astype(np.int32)
    kv_valid = np.array([20, 7, 1], np.int32)
    ref = jl.attention_mask(jnp.asarray(q_pos), 24, jnp.asarray(kv_valid))
    out = tl.attention_mask(_t(q_pos), 24, _t(kv_valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_naive_attention(cap, rng):
    b, sq, skv, hq, hkv, d = 2, 6, 10, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32) * 3
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32) * 3
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    mask = rng.random((b, sq, skv)) < 0.7
    mask[..., 0] = True
    ref = jl.naive_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), logit_cap=cap)
    out = tl.naive_attention(_t(q), _t(k), _t(v), _t(mask), logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("sq", [1, 5])
def test_attention_dispatch(impl, sq, rng):
    """Both CPU paths (plain naive, and the kernels' plain versions that
    ``impl="pallas"`` takes) against the JAX dispatch, decode (Sq=1)
    included."""
    b, skv, hq, hkv, d = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    start = np.array([3, 7])
    q_pos = (start[:, None] + np.arange(sq)[None]).astype(np.int32)
    kv_valid = (start + sq).astype(np.int32)
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_valid)), impl=impl)
    out = tl.attention(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_valid), impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kw", [dict(causal=False)], ids=["non-causal"])
def test_attention_outside_the_slice_raises(kw, rng):
    """The slices' boundary of attention: non-causal attention, which once
    raised here, is ported (the encoder-decoder slice) and now matches the
    JAX dispatch; an attention impl the port does not have still raises."""
    b, sq, skv, hq, hkv, d = 1, 2, 4, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    q_pos = np.zeros((b, sq), np.int32)
    ref = jl.attention(*(jnp.asarray(a) for a in (q, k, k, q_pos)), **kw)
    out = tl.attention(_t(q), _t(k), _t(k), _t(q_pos), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(NotImplementedError):
        tl.attention(_t(q), _t(k), _t(k), _t(q_pos), impl="splash", **kw)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act, rng):
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    ref = jl.gated_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act)
    out = tl.gated_mlp(_t(x), _t(wg), _t(wu), _t(wd), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_initializers_match_jax_distributions():
    """Same distribution as the JAX initializers (the bits differ: a
    torch.Generator is not jax.random)."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (256, 512), torch.float32, torch.device("cpu"))
    e = tl.embed_init(gen, (512, 256), torch.float32, torch.device("cpu"))
    jw = jl.dense_init(jax.random.key(0), (256, 512), jnp.float32)
    assert abs(w.std().item() - float(jnp.std(jw))) < 2e-3
    assert abs(e.std().item() - 0.02) < 5e-4 and abs(e.mean().item()) < 5e-4
    assert tl.dense_init(gen, (4, 4), torch.bfloat16, torch.device("cpu")).dtype == torch.bfloat16


def test_greedy_sampling_takes_first_maximum(rng):
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[1, [3, 17]] = 9.0  # a tie: both pick the first
    ref = np.asarray(jax_sample(jnp.asarray(logits)))
    out = sample(_t(logits))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[1] == 3


def test_temperature_sampling_follows_the_distribution():
    """Sampling cannot match jax.random bit for bit: check the distribution
    and that top-k never leaves the k largest."""
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = sample(logits, temperature=1.0, generator=gen)
    freq = torch.bincount(toks.long(), minlength=4).float() / len(toks)
    torch.testing.assert_close(freq, torch.tensor([0.1, 0.2, 0.3, 0.4]), atol=0.03, rtol=0)
    top = sample(logits, temperature=1.0, top_k=2, generator=gen)
    assert set(top.tolist()) <= {2, 3}
    with pytest.raises(ValueError):
        sample(logits, temperature=1.0)


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "zamba2-2.7b-smoke"])
def test_configs_outside_the_slice_raise(arch):
    # every family is ported, with any number of B/C groups that divides the
    # SSM heads; a count that does not (8 heads, 3 or 16 groups) is refused
    for g in (3, 16):
        with pytest.raises(ValueError, match="ngroups"):
            build_model(get_config(arch).replace(ssm_ngroups=g))
    assert build_model(get_config(arch).replace(ssm_ngroups=8)).cfg.ssm_ngroups == 8
