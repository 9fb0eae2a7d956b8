"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` with the same weights: the grouped one-hot dispatch
with capacity at a capacity factor that drops tokens (1.25) and at one
that drops none (8.0, where it equals the dense oracle), over a padded
last group, for the smoke configs of every MoE architecture."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["grok-1-314b-smoke", "phi3.5-moe-42b-a6.6b-smoke", "minimax-m2.5-proxy-smoke"]


def _pair(arch, capacity_factor):
    kw = dict(dtype="float32", capacity_factor=capacity_factor)
    jcfg, cfg = jax_get_config(arch).replace(**kw), get_config(arch).replace(**kw)
    jp = jmoe.init_moe_params(jax.random.key(0), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _x(rng, cfg, shape=(3, 25)):
    """75 tokens (groups of moe_group_size = 32, the last padded with 21
    rows) sharing one direction, so that the router favours the same
    experts and capacity 1.25 binds."""
    common = rng.standard_normal(cfg.d_model)
    x = rng.standard_normal((*shape, cfg.d_model)) + 1.5 * common
    return (x / 8).astype(np.float32)  # outputs of order one


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, capacity_factor, rng):
    jcfg, cfg, jp, tp = _pair(arch, capacity_factor)
    x = _x(rng, cfg)
    assert (x.shape[0] * x.shape[1]) % cfg.moe_group_size  # a padded last group
    ref = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
    out = tmoe.moe_ffn(torch.from_numpy(x), tp, cfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # 1.25 drops tokens (the output departs from the no-drop oracle), 8.0 none
    oracle = tmoe.moe_ffn_ref(torch.from_numpy(x), tp, cfg).numpy()
    assert np.allclose(out.numpy(), oracle, **TOL) == (capacity_factor == 8.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_drop_capacity_equals_the_dense_oracle(arch, rng):
    """The port's dense oracle equals the reference's, and at capacity
    factor 8 (nothing dropped) moe_ffn equals it."""
    jcfg, cfg, jp, tp = _pair(arch, 8.0)
    x = _x(rng, cfg)
    oracle = tmoe.moe_ffn_ref(torch.from_numpy(x), tp, cfg)
    ref = jmoe.moe_ffn_ref(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tmoe.moe_ffn(torch.from_numpy(x), tp, cfg).numpy(),
                               oracle.numpy(), **TOL)


def test_capacity_is_the_reference_rule():
    """phi3.5-moe's 512-token chunk: 80 slots per expert against 64 choices on
    average, so a skewed chunk drops; the floor is 8 slots."""
    cfg, jcfg = get_config("phi3.5-moe-42b-a6.6b"), jax_get_config("phi3.5-moe-42b-a6.6b")
    for tokens in (1, 8, 100, 512, 2048):
        assert cfg.moe_capacity(tokens) == jcfg.moe_capacity(tokens)
    assert cfg.moe_capacity(512) == 80 and cfg.moe_capacity(8) == 8


def test_padding_rows_use_capacity_as_in_the_reference(rng):
    """Rows the caller will discard (a chunk's padding, the engine's scratch
    lanes) take part in routing: appending them changes the valid rows'
    output when capacity binds, in the port as in the reference."""
    jcfg, cfg, jp, tp = _pair("phi3.5-moe-42b-a6.6b-smoke", 0.5)
    x = _x(rng, cfg, (1, 20))
    # 12 copies of a row whose first choice is the valid rows' most common
    # second choice: k = 0 choices come first, so they take its slots
    _, topi = tmoe._route(torch.from_numpy(x).reshape(20, -1), tp["router"], 2)
    second = torch.mode(topi[:, 1]).values
    r = int(torch.nonzero(topi[:, 0] == second)[0, 0])
    pad = np.repeat(x[:, r : r + 1], 12, axis=1)
    both = np.concatenate([x, pad], axis=1)
    alone = tmoe.moe_ffn(torch.from_numpy(x), tp, cfg).numpy()
    padded = tmoe.moe_ffn(torch.from_numpy(both), tp, cfg).numpy()
    ref = np.asarray(jmoe.moe_ffn(jnp.asarray(both), jp, jcfg))
    np.testing.assert_allclose(padded, ref, **TOL)
    assert not np.allclose(padded[:, :20], alone, **TOL)


def test_top_k_ties_take_the_first_index():
    gates = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 2)
    tv, ti = tmoe._top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_init_matches_the_reference_distributions():
    """The router is f32 whatever the model dtype; w_down is scaled by its
    input axis (d_ff), w_gate and w_up by their leading axis (the experts),
    as the reference's ``dense_init`` with its default ``in_axis=0``."""
    cfg = get_config("phi3.5-moe-42b-a6.6b-smoke").replace(d_model=256, d_ff=1024)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(gen, cfg, torch.bfloat16, torch.device("cpu"))
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    assert tuple(p["w_down"].shape) == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    assert abs(p["w_down"].float().std().item() - 1024 ** -0.5) < 2e-3
    assert abs(p["w_up"].float().std().item() - cfg.num_experts ** -0.5) < 4e-3
