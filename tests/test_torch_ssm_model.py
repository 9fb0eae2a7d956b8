"""The port's ssm and hybrid families against ``repro.models`` with the same
weights: bridged ``mamba2-130m-smoke`` and ``zamba2-2.7b-smoke`` f32
parameters, prefill logits and the whole prefill cache tree within 2e-4,
then 8 greedy decode steps from that tree with logits within 2e-4 and equal
tokens; the parameter and cache structure; the two faults of the
reference the port repairs (ROADMAP C2, C3); and both models with several
groups of B and C (``ssm_ngroups`` 2, 4 and 8 over their 8 heads): prefill
logits and cache within 2e-4 and 8 greedy tokens equal to JAX's.

Cross-package tests keep prompts unpadded (C2 makes padded ones differ on
purpose) and hand the prefill's own cache tree to decode on both sides, so
neither side goes through the reference's bfloat16 conv spec (C3).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import cache_struct as jax_cache_struct  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, cache_struct  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models_numerics.py
ARCHS = ["mamba2-130m-smoke", "zamba2-2.7b-smoke"]


@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX cfg, port cfg, JAX f32 params, the same as tensors)."""
    out = {}
    for name in ARCHS:
        jcfg = jax_get_config(name).replace(dtype="float32")
        cfg = get_config(name).replace(dtype="float32")
        jp = jax_build_model(jcfg).init(jax.random.key(0))
        out[name] = (jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                    device="cpu"))
    return out


def _np(t):
    return t.detach().float().numpy()


def _jax_decode_cache(cfg, kv, max_len):
    """The reference's decode cache made from its own prefill tree: the
    recurrent leaves as they are, K/V padded to ``max_len`` positions."""
    if cfg.family == "ssm":
        return dict(conv=kv["conv"], state=kv["state"])
    rec, (k, v) = kv
    pad = ((0, 0), (0, 0), (0, max_len - k.shape[2]), (0, 0), (0, 0))
    return dict(conv=rec["conv"], state=rec["state"], k=jnp.pad(k, pad), v=jnp.pad(v, pad))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_tree_match_jax(pairs, arch, rng):
    jcfg, cfg, jp, tp = pairs[arch]
    toks = rng.integers(2, cfg.vocab_size, (2, 21))
    jl, jkv = jt.prefill_step(jp, jnp.asarray(toks, jnp.int32), jcfg)
    tl, tkv = tt.prefill_step(tp, torch.tensor(toks), cfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    jleaves, tleaves = jax.tree.leaves(jkv), jax.tree.leaves(tkv)
    assert [a.shape for a in jleaves] == [tuple(t.shape) for t in tleaves]
    for a, t in zip(jleaves, tleaves, strict=True):
        np.testing.assert_allclose(_np(t), np.asarray(a), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_after_prefill_matches_jax(pairs, arch, rng):
    """8 greedy steps from each side's own prefill tree: logits within 2e-4
    at every step and the same tokens."""
    jcfg, cfg, jp, tp = pairs[arch]
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    s, n_new = 13, 8
    toks = rng.integers(2, cfg.vocab_size, (2, s))
    jl, jkv = jm.prefill(jp, dict(inputs=jnp.asarray(toks, jnp.int32)))
    tl, tkv = tm.prefill(tp, dict(inputs=torch.tensor(toks)))
    jc = _jax_decode_cache(jcfg, jkv, s + n_new)
    tc = tt.handoff(cfg, tkv, tm.init_cache(2, s + n_new, device="cpu"))
    for step in range(n_new):
        jtok, ttok = np.asarray(jnp.argmax(jl, -1)), torch.argmax(tl, -1)
        assert ttok.tolist() == jtok.tolist(), f"step {step}"
        pos = np.full((2,), s + step)
        jl, jc = jm.decode(jp, jnp.asarray(jtok[:, None], jnp.int32), jnp.asarray(pos, jnp.int32),
                           jc)
        tl, tc = tm.decode(tp, ttok[:, None], torch.tensor(pos), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for name in jc:
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax_param_struct(arch):
    """Shapes and dtypes of the port's init equal JAX ``Model.param_struct``
    (bf16 model, f32 SSM scalars)."""
    tp = build_model(get_config(arch)).init(0, device="cpu")
    js = jax_build_model(jax_get_config(arch)).param_struct()
    tstruct = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tp)
    jstruct = jax.tree.map(lambda a: (a.shape, str(a.dtype)), js)
    assert tstruct == jstruct


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_keeps_the_conv_window_of_the_valid_rows(pairs, arch, rng):
    """ROADMAP C2: a prompt right-padded to 16 with valid_len=10 gives the
    same conv, state (and K/V rows) and next decode logits as the prompt
    alone. The reference takes the last W-1 rows whatever valid_len says
    (src/repro/models/ssm.py:174), so its padded conv holds padding."""
    _, cfg, _, tp = pairs[arch]
    tm = build_model(cfg)
    prompt = rng.integers(2, cfg.vocab_size, (1, 10))
    padded = np.concatenate([prompt, rng.integers(2, cfg.vocab_size, (1, 6))], axis=1)
    la, kva = tm.prefill(tp, dict(inputs=torch.tensor(prompt)))
    lb, kvb = tm.prefill(tp, dict(inputs=torch.tensor(padded)),
                         valid_len=torch.tensor([10], dtype=torch.int32))
    np.testing.assert_allclose(_np(lb), _np(la), rtol=1e-5, atol=1e-5)
    ca = tt.handoff(cfg, kva, tm.init_cache(1, 24, device="cpu"))
    cb = tt.handoff(cfg, kvb, tm.init_cache(1, 24, device="cpu"))
    if "k" in cb:  # the padded prefill's K/V rows past valid_len are not part of the cache
        cb["k"][:, :, 10:] = 0
        cb["v"][:, :, 10:] = 0
    for name in ca:
        np.testing.assert_allclose(_np(cb[name]), _np(ca[name]), rtol=1e-5, atol=1e-5)
    nxt, pos = torch.tensor([[7]]), torch.tensor([10])
    la2, _ = tm.decode(tp, nxt, pos, ca)
    lb2, _ = tm.decode(tp, nxt, pos, cb)
    np.testing.assert_allclose(_np(lb2), _np(la2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_cache_dtype_follows_the_model(arch, dtype):
    """ROADMAP C3: the reference's spec gives the conv leaf bfloat16 whatever
    the model's dtype (src/repro/models/ssm.py:241) while its decode returns
    the model's dtype; the port writes caches in place, so its conv leaf has
    cfg.dtype. Shapes, and every other dtype, equal the reference's."""
    cfg = get_config(arch).replace(dtype=dtype)
    ts = cache_struct(cfg, 3, 40)
    js = jax_cache_struct(jax_get_config(arch).replace(dtype=dtype), 3, 40)
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: v.shape for k, v in js.items()}
    assert ts["conv"].dtype == getattr(torch, dtype)
    assert str(js["conv"].dtype) == "bfloat16"
    for k in ts:
        if k != "conv":
            assert str(ts[k].dtype).removeprefix("torch.") == str(js[k].dtype)
    assert all(v.device.type == "meta" for v in ts.values())


def test_bridge_checks_the_layer_axes(pairs):
    for arch in ARCHS:
        _, cfg, jp, _ = pairs[arch]
        tree = jax.tree.map(np.asarray, jp)
        short = cfg.replace(num_layers=cfg.num_layers + cfg.hybrid_period if cfg.hybrid_period
                            else cfg.num_layers + 1)
        with pytest.raises(ValueError, match="layer axes"):
            params_from_jax(tree, short, device="cpu")
    _, cfg, jp, _ = pairs["zamba2-2.7b-smoke"]
    tree = jax.tree.map(np.asarray, jp)
    tree.pop("shared_attn")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, cfg, device="cpu")


def test_unported_variants_raise(pairs):
    # several groups are ported (below); a count that does not divide the
    # heads is refused, as the reference fails inside jnp.repeat
    _, cfg, _, tp = pairs["mamba2-130m-smoke"]
    with pytest.raises(ValueError, match="ngroups"):
        build_model(cfg.replace(ssm_ngroups=3))
    cache = build_model(cfg).init_cache(1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tt.chunk_prefill_step(tp, torch.zeros(1, 8, dtype=torch.long), [0], [8], cfg, cache)


GROUPS = [2, 4, 8]  # every G > 1 that divides the smoke models' 8 heads


@pytest.fixture(scope="module")
def grouped_pairs():
    """(arch, G) -> the `pairs` tuple of the arch at ssm_ngroups=G."""
    out = {}
    for name in ARCHS:
        for g in GROUPS:
            jcfg = jax_get_config(name).replace(dtype="float32", ssm_ngroups=g)
            cfg = get_config(name).replace(dtype="float32", ssm_ngroups=g)
            jp = jax_build_model(jcfg).init(jax.random.key(0))
            out[name, g] = (jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                           device="cpu"))
    return out


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_prefill_and_greedy_decode_match_jax(grouped_pairs, arch, g, rng):
    """Prefill logits and the cache tree within 2e-4, then 8 greedy steps
    from each side's own tree: logits within 2e-4 and the same tokens."""
    jcfg, cfg, jp, tp = grouped_pairs[arch, g]
    assert cfg.ssm_num_heads // g * g == cfg.ssm_num_heads
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    s, n_new = 21, 8
    toks = rng.integers(2, cfg.vocab_size, (2, s))
    jl, jkv = jm.prefill(jp, dict(inputs=jnp.asarray(toks, jnp.int32)))
    tl, tkv = tm.prefill(tp, dict(inputs=torch.tensor(toks)))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)
    for a, t in zip(jax.tree.leaves(jkv), jax.tree.leaves(tkv), strict=True):
        np.testing.assert_allclose(_np(t), np.asarray(a), **LOGIT_TOL)
    jc = _jax_decode_cache(jcfg, jkv, s + n_new)
    tc = tt.handoff(cfg, tkv, tm.init_cache(2, s + n_new, device="cpu"))
    for step in range(n_new):
        jtok, ttok = np.asarray(jnp.argmax(jl, -1)), torch.argmax(tl, -1)
        assert ttok.tolist() == jtok.tolist(), f"step {step}"
        pos = np.full((2,), s + step)
        jl, jc = jm.decode(jp, jnp.asarray(jtok[:, None], jnp.int32), jnp.asarray(pos, jnp.int32),
                           jc)
        tl, tc = tm.decode(tp, ttok[:, None], torch.tensor(pos), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_param_tree_matches_jax_param_struct(arch, g):
    """The in_proj and conv widths of G groups: the port's init, its
    param_struct and count_params equal JAX's."""
    cfg = get_config(arch).replace(ssm_ngroups=g)
    model = build_model(cfg)
    js = jax_build_model(jax_get_config(arch).replace(ssm_ngroups=g)).param_struct()
    jstruct = jax.tree.map(lambda a: (a.shape, str(a.dtype)), js)
    for tree in (model.init(0, device="cpu"), model.param_struct()):
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")),
                            tree) == jstruct
    assert cfg.count_params() == jax_get_config(arch).replace(ssm_ngroups=g).count_params()
