"""The port's SSD scan and Mamba2 block against ``repro``'s on the CPU.

The `ssd` wrapper (its plain version on a CPU tensor) is held against JAX
``ssd_chunked`` over the sweep of tests/test_kernels.py, a sequence shorter
than one chunk and an initial state, and against the JAX Pallas wrapper in
interpret mode, all in f32 at 1e-4 (the JAX kernel test's tolerance). The
Mamba2 layers (``gated_rms_norm``, ``causal_conv``, ``ssm_forward``,
``ssm_decode_step``) are held against their JAX twins at
``mamba2-130m-smoke`` f32 within 2e-4, with the JAX initializer's weights.
The tensor-core route's rounding points, written out in
``ref.ssd_tensor_core_emulation``, are held against JAX ``ssd_chunked`` in
f32 within the route's relative-norm limit, and ``ops.route`` sends the
serving shapes to that route. Several groups of B and C (``ssm_ngroups``):
the scan and the emulation at G = 2, G = H and an odd number of heads per
group, with an initial state, the layers at G = 2 and 8, the refusal of a
G that does not divide the heads, the mesh's cut of the groups, and the
bytes ``work`` and ``bwd_work`` count (the kernel table's bounds). The CUDA
kernels themselves are held against the plain version on the card by
chip_smoke.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    SCALAR,
    TC_REL_LIMIT,
    TENSOR_CORE,
    route,
    ssd,
)
from repro_torch.kernels.ssd_scan.ref import ssd_tensor_core_emulation  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models.convert import _tensor  # noqa: E402

SSD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models_numerics.py

SSD_CASES = [
    (2, 256, 4, 64, 32, 64),  # the sweep of tests/test_kernels.py
    (1, 100, 2, 32, 16, 32),
    (2, 128, 8, 16, 64, 128),
    (2, 50, 3, 16, 32, 128),  # L shorter than one chunk
]


def _ssd_inputs(rng, b, l, h, p, n):
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 4.0, (h,))).astype(np.float32)
    Bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_matches_jax_ssd_chunked(case, rng):
    b, l, h, p, n, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l, h, p, n)
    yr, fsr = js.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm[:, :, None]), jnp.asarray(Cm[:, :, None]), chunk)
    y, fs = ssd(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    assert y.dtype == torch.float32 and fs.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(y), np.asarray(yr), **SSD_TOL)
    np.testing.assert_allclose(_np(fs), np.asarray(fsr), **SSD_TOL)


def test_ssd_with_initial_state_matches_jax(rng):
    b, l, h, p, n, chunk = 2, 160, 4, 32, 16, 64
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l, h, p, n)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    yr, fsr = js.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm[:, :, None]), jnp.asarray(Cm[:, :, None]), chunk,
                             jnp.asarray(s0))
    y, fs = ssd(*_t(x, dt, A, Bm, Cm), chunk=chunk, init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(_np(y), np.asarray(yr), **SSD_TOL)
    np.testing.assert_allclose(_np(fs), np.asarray(fsr), **SSD_TOL)


@pytest.mark.parametrize("case", [(1, 100, 2, 32, 16, 32), (2, 128, 8, 16, 64, 128)])
def test_ssd_matches_pallas_interpret(case, rng):
    """The port's wrapper against the JAX Pallas wrapper in interpret mode."""
    b, l, h, p, n, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l, h, p, n)
    yr, fsr = jax_ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)
    y, fs = ssd(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(yr), **SSD_TOL)
    np.testing.assert_allclose(_np(fs), np.asarray(fsr), **SSD_TOL)


def test_ssd_state_feeds_decode(rng):
    """The twin of tests/test_kernels.py::test_ssd_kernel_state_feeds_decode:
    the scan's final state continues through one recurrent step."""
    b, l, h, p, n = 1, 64, 2, 16, 8
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(rng, b, l + 1, h, p, n))
    y_all, _ = ssd(x, dt, A, Bm, Cm, chunk=32)
    _, fs = ssd(x[:, :l], dt[:, :l], A, Bm[:, :l], Cm[:, :l], chunk=32)
    dA = torch.exp(dt[:, l] * A)  # (b, h)
    inc = torch.einsum("bhp,bn->bhpn", x[:, l] * dt[:, l][..., None], Bm[:, l])
    state = fs * dA[..., None, None] + inc
    y_step = torch.einsum("bn,bhpn->bhp", Cm[:, l], state)
    np.testing.assert_allclose(_np(y_step), _np(y_all[:, l]), **SSD_TOL)


def test_cpu_ssd_does_not_launch(rng):
    before = ssd.launches
    ssd(*_t(*_ssd_inputs(rng, 1, 20, 2, 16, 16)), chunk=8)
    assert ssd.launches == before


def test_ssd_rejects_a_missing_sequence():
    with pytest.raises(ValueError, match="L >= 1"):
        ssd(torch.zeros(1, 0, 2, 16), torch.zeros(1, 0, 2), torch.ones(2), torch.zeros(1, 0, 16),
            torch.zeros(1, 0, 16))


def _rel(out, ref):
    return float(np.linalg.norm(_np(out) - np.asarray(ref)) / np.linalg.norm(np.asarray(ref)))


@pytest.mark.parametrize("case", [
    (2, 300, 3, 64, 64, 128),  # zamba2's P, N, Q; ragged last chunk
    (2, 300, 4, 64, 128, 128),  # mamba2's
    (1, 150, 2, 32, 32, 64),  # the route's smallest P, N and Q
])
def test_tensor_core_emulation_within_the_limit_of_jax(case, rng):
    """The tensor-core route's rounding points (bf16 inputs, scaled x, S_in
    and decayed scores rounded to bf16; y out in bf16) keep y and the final
    state within TC_REL_LIMIT of the JAX chunked scan in f32 on the same
    inputs, at a ragged L with an initial state."""
    b, l, h, p, n, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(rng, b, l, h, p, n)
    x, Bm, Cm = (_np(torch.from_numpy(a).bfloat16()) for a in (x, Bm, Cm))  # bf16 values
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    yr, fsr = js.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm[:, :, None]), jnp.asarray(Cm[:, :, None]), chunk,
                             jnp.asarray(s0))
    xt, dtt, At, Bt, Ct = _t(x, dt, A, Bm, Cm)
    y, fs = ssd_tensor_core_emulation(xt.bfloat16(), dtt, At, Bt.bfloat16(), Ct.bfloat16(), chunk,
                                      torch.from_numpy(s0))
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32
    assert _rel(y, yr) <= TC_REL_LIMIT and _rel(fs, fsr) <= TC_REL_LIMIT
    assert _rel(y, yr) > 1e-4  # the roundings are there: the f32 scan itself agrees to ~1e-7


@pytest.mark.parametrize("arch,dtype,chunk,want", [
    ("zamba2-2.7b", torch.bfloat16, None, TENSOR_CORE),
    ("mamba2-130m", torch.bfloat16, None, TENSOR_CORE),
    ("zamba2-2.7b", torch.float32, None, SCALAR),  # f32 is held to 1e-4: scalar FMAs
    ("mamba2-130m", torch.bfloat16, 32, SCALAR),  # Q = 32 is not a route shape
])
def test_route_of_the_serving_shapes(arch, dtype, chunk, want):
    cfg = get_config(arch)
    q = cfg.ssm_chunk if chunk is None else chunk
    assert route(dtype, cfg.ssm_head_dim, cfg.ssm_state_dim, q) == want


# ---------------------------------------------------------------- Mamba2 block

@pytest.fixture(scope="module")
def block():
    """mamba2-130m-smoke f32: the JAX config, the port's, one layer's JAX
    weights and the same weights as tensors."""
    jcfg = jax_get_config("mamba2-130m-smoke").replace(dtype="float32")
    cfg = get_config("mamba2-130m-smoke").replace(dtype="float32")
    jp = js.init_ssm_params(jax.random.key(0), jcfg, jnp.float32)
    tp = {k: _tensor(np.asarray(v), torch.device("cpu")) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def test_gated_rms_norm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    gate = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal(48) * 0.1).astype(np.float32)
    ref = jl.gated_rms_norm(jnp.asarray(x), jnp.asarray(gate), jnp.asarray(w), 1e-6)
    out = tl.gated_rms_norm(*_t(x, gate, w), 1e-6)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MODEL_TOL)


def test_causal_conv_matches_jax(block, rng):
    jcfg, _, jp, tp = block
    x = rng.standard_normal((2, 9, ts.conv_channels(jcfg))).astype(np.float32)
    ref = js.causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    out = ts.causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MODEL_TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_ssm_forward_matches_jax(block, with_cache, rng):
    """Unpadded prompts (C2 makes padded ones differ from the reference on
    purpose), with and without a cache to continue from."""
    jcfg, cfg, jp, tp = block
    b, l = 2, 37
    x = (rng.standard_normal((b, l, cfg.d_model)) * 0.3).astype(np.float32)
    jcache = tcache = None
    if with_cache:
        conv = rng.standard_normal((b, cfg.ssm_conv_width - 1, ts.conv_channels(cfg)))
        state = rng.standard_normal((b, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim))
        conv, state = conv.astype(np.float32), state.astype(np.float32)
        jcache = dict(conv=jnp.asarray(conv), state=jnp.asarray(state))
        tcache = dict(conv=torch.from_numpy(conv), state=torch.from_numpy(state))
    yr, cr = js.ssm_forward(jp, jnp.asarray(x), jcfg, init_cache=jcache)
    y, c = ts.ssm_forward(tp, torch.from_numpy(x), cfg, init_cache=tcache)
    np.testing.assert_allclose(_np(y), np.asarray(yr), **MODEL_TOL)
    for k in ("conv", "state"):
        assert c[k].dtype == torch.float32
        np.testing.assert_allclose(_np(c[k]), np.asarray(cr[k]), **MODEL_TOL)


def test_ssm_decode_step_matches_jax(block, rng):
    jcfg, cfg, jp, tp = block
    b = 3
    x = (rng.standard_normal((b, 1, cfg.d_model)) * 0.3).astype(np.float32)
    conv = rng.standard_normal((b, cfg.ssm_conv_width - 1, ts.conv_channels(cfg)))
    state = rng.standard_normal((b, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim))
    conv, state = conv.astype(np.float32), state.astype(np.float32)
    yr, cr = js.ssm_decode_step(jp, jnp.asarray(x), jcfg,
                                dict(conv=jnp.asarray(conv), state=jnp.asarray(state)))
    y, c = ts.ssm_decode_step(tp, torch.from_numpy(x), cfg,
                              dict(conv=torch.from_numpy(conv), state=torch.from_numpy(state)))
    np.testing.assert_allclose(_np(y), np.asarray(yr), **MODEL_TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(_np(c[k]), np.asarray(cr[k]), **MODEL_TOL)


def test_init_ssm_params_follow_the_reference_distributions():
    cfg = get_config("mamba2-130m")
    p = ts.init_ssm_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                           torch.device("cpu"))
    jshapes = jax.eval_shape(lambda k: js.init_ssm_params(k, jax_get_config("mamba2-130m"),
                                                          jnp.bfloat16), jax.random.key(0))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in p.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jshapes.items()}
    dt = torch.nn.functional.softplus(p["dt_bias"])  # inverse-softplus of U-log[1e-3, 1e-1]
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    a = torch.exp(p["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert torch.equal(p["D"], torch.ones_like(p["D"])) and not p["norm"].any()
    assert abs(float(p["conv_w"].float().std()) - 0.5) < 0.02  # N(0, 1) / sqrt(W = 4)


# ------------------------------------------------ several groups of B and C

# (B, L, H, P, N, chunk, G): two groups; one head a group (G = H); 3 heads a
# group, odd; L below one chunk with 2 heads a group
GROUP_CASES = [
    (2, 100, 4, 16, 16, 32, 2),
    (1, 90, 4, 32, 16, 32, 4),
    (2, 70, 6, 16, 32, 32, 2),
    (1, 50, 6, 16, 16, 64, 3),
]


def _grouped_inputs(rng, b, l, h, p, n, g):
    x, dt, A, _, _ = _ssd_inputs(rng, b, l, h, p, n)
    Bm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("case", GROUP_CASES)
def test_grouped_ssd_matches_jax_ssd_chunked(case, rng):
    """Head h reads group h // (H // G), as the reference's jnp.repeat."""
    b, l, h, p, n, chunk, g = case
    x, dt, A, Bm, Cm, s0 = _grouped_inputs(rng, b, l, h, p, n, g)
    yr, fsr = js.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), min(chunk, l),
                             jnp.asarray(s0))
    y, fs = ssd(*_t(x, dt, A, Bm, Cm), chunk=chunk, init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(_np(y), np.asarray(yr), **SSD_TOL)
    np.testing.assert_allclose(_np(fs), np.asarray(fsr), **SSD_TOL)


@pytest.mark.parametrize("case", [(2, 300, 4, 64, 64, 128, 2), (1, 200, 6, 32, 128, 64, 2),
                                  (1, 150, 4, 64, 32, 128, 4)])
def test_grouped_tensor_core_emulation_within_the_limit_of_jax(case, rng):
    """The tensor-core route's rounding points at G > 1 (the scores of each
    group, read by its heads) keep y and the final state within
    TC_REL_LIMIT of the JAX scan in f32 on the same bf16 values."""
    b, l, h, p, n, chunk, g = case
    x, dt, A, Bm, Cm, s0 = _grouped_inputs(rng, b, l, h, p, n, g)
    x, Bm, Cm = (_np(torch.from_numpy(a).bfloat16()) for a in (x, Bm, Cm))
    yr, fsr = js.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk, jnp.asarray(s0))
    xt, dtt, At, Bt, Ct = _t(x, dt, A, Bm, Cm)
    y, fs = ssd_tensor_core_emulation(xt.bfloat16(), dtt, At, Bt.bfloat16(), Ct.bfloat16(), chunk,
                                      torch.from_numpy(s0))
    assert _rel(y, yr) <= TC_REL_LIMIT and _rel(fs, fsr) <= TC_REL_LIMIT
    assert _rel(y, yr) > 1e-4


def test_one_group_takes_either_layout(rng):
    """(B, L, N) and (B, L, 1, N) are the same scan."""
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(rng, 2, 40, 3, 16, 16))
    y, fs = ssd(x, dt, A, Bm, Cm, chunk=16)
    y1, fs1 = ssd(x, dt, A, Bm[:, :, None], Cm[:, :, None], chunk=16)
    assert torch.equal(y, y1) and torch.equal(fs, fs1)


@pytest.mark.parametrize("shapes", [((1, 8, 3, 16), (1, 8, 3, 16)),  # 6 heads, 3 groups: fine
                                    ((1, 8, 4, 16), (1, 8, 4, 16)),  # 6 heads, 4 groups
                                    ((1, 8, 2, 16), (1, 8, 16))])  # B and C laid out apart
def test_ssd_refuses_groups_it_cannot_read(shapes, rng):
    x, dt, A, _, _ = _t(*_ssd_inputs(rng, 1, 8, 6, 16, 16))
    Bm, Cm = torch.zeros(shapes[0]), torch.zeros(shapes[1])
    if shapes[0] == shapes[1] and 6 % shapes[0][2] == 0:
        assert ssd(x, dt, A, Bm, Cm, chunk=8)[0].shape == x.shape
        return
    with pytest.raises(ValueError, match="groups|B and C"):
        ssd(x, dt, A, Bm, Cm, chunk=8)


@pytest.fixture(scope="module", params=[2, 8])
def grouped_block(request):
    """`block` at ssm_ngroups 2 and 8 (8 heads: 4 and 1 a group)."""
    g = request.param
    jcfg = jax_get_config("mamba2-130m-smoke").replace(dtype="float32", ssm_ngroups=g)
    cfg = get_config("mamba2-130m-smoke").replace(dtype="float32", ssm_ngroups=g)
    jp = js.init_ssm_params(jax.random.key(0), jcfg, jnp.float32)
    tp = {k: _tensor(np.asarray(v), torch.device("cpu")) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def test_grouped_ssm_forward_and_decode_step_match_jax(grouped_block, rng):
    """The layer with several groups: the scan from a cache, then one
    recurrent step from its cache, each against JAX within 2e-4."""
    jcfg, cfg, jp, tp = grouped_block
    b, l = 2, 37
    x = (rng.standard_normal((b, l, cfg.d_model)) * 0.3).astype(np.float32)
    conv = rng.standard_normal((b, cfg.ssm_conv_width - 1, ts.conv_channels(cfg)))
    state = rng.standard_normal((b, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim))
    conv, state = conv.astype(np.float32), state.astype(np.float32)
    yr, cr = js.ssm_forward(jp, jnp.asarray(x), jcfg,
                            init_cache=dict(conv=jnp.asarray(conv), state=jnp.asarray(state)))
    y, c = ts.ssm_forward(tp, torch.from_numpy(x), cfg,
                          init_cache=dict(conv=torch.from_numpy(conv),
                                          state=torch.from_numpy(state)))
    np.testing.assert_allclose(_np(y), np.asarray(yr), **MODEL_TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(_np(c[k]), np.asarray(cr[k]), **MODEL_TOL)
    step = (rng.standard_normal((b, 1, cfg.d_model)) * 0.3).astype(np.float32)
    yr, cr = js.ssm_decode_step(jp, jnp.asarray(step), jcfg, cr)
    y, c = ts.ssm_decode_step(tp, torch.from_numpy(step), cfg, c)
    np.testing.assert_allclose(_np(y), np.asarray(yr), **MODEL_TOL)
    np.testing.assert_allclose(_np(c["state"]), np.asarray(cr["state"]), **MODEL_TOL)


@pytest.mark.parametrize("h,g,h_loc", [(8, 2, 2), (8, 2, 4), (8, 8, 2), (8, 1, 4), (12, 2, 4),
                                       (12, 4, 2), (12, 3, 6), (24, 8, 4)])
def test_a_rank_scans_with_the_groups_its_heads_read(h, g, h_loc):
    """`_local_groups`: each rank's cut of B and C, read by its heads as
    the scan reads groups (local head k reads local group k // (h_loc //
    groups)), gives every head the group the whole scan gives it: whole
    groups, heads inside one group, or (12 heads, 3 groups over 4 heads a
    rank; 24 heads, 8 groups) one expanded group per head."""
    Bm = torch.arange(2 * 3 * g * 4, dtype=torch.float32).reshape(2, 3, g, 4)
    Cm = -Bm
    rep = h // g
    for lo in range(0, h, h_loc):
        bm, cm = ts._local_groups(Bm, Cm, h, lo, h_loc)
        assert h_loc % bm.shape[2] == 0 and bm.shape == cm.shape
        for k in range(h_loc):
            local = k // (h_loc // bm.shape[2])
            assert torch.equal(bm[:, :, local], Bm[:, :, (lo + k) // rep])
            assert torch.equal(cm[:, :, local], Cm[:, :, (lo + k) // rep])
        if h_loc % rep and rep % h_loc:
            assert bm.shape[2] == h_loc  # expanded


@pytest.mark.parametrize("arch,g,fwd_ms,bwd_ms", [
    ("zamba2-2.7b", 1, 0.0531, 0.1030), ("zamba2-2.7b", 8, 0.0574, 0.1117),
    ("mamba2-130m", 1, 0.0175, 0.0405), ("mamba2-130m", 8, 0.0262, 0.0581)])
def test_work_counts_the_bytes_of_every_group(arch, g, fwd_ms, bwd_ms):
    """The bounds of the kernel table (roofline.analysis.bound on hw.H100)
    at the ssm phase's B = 4, L = 2048 in bf16: B and C (and dB, dC) bytes
    grow with G, the operations do not."""
    from repro_torch.kernels.ssd_scan.ops import bwd_work, work
    from repro_torch.roofline.analysis import bound

    cfg = get_config(arch)
    shape = (4, 2048, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_chunk, 2)
    for fn, want in ((work, fwd_ms), (bwd_work, bwd_ms)):
        ms, by = bound(*fn(*shape, g), torch.bfloat16)
        assert round(ms, 4) == want and by == "bytes", (fn.__name__, ms)
        assert fn(*shape, g)[0] == fn(*shape)[0]
        assert fn(*shape, g)[1] - fn(*shape)[1] == (2 if fn is work else 4) * 2 * 4 * 2048 * (
            g - 1) * cfg.ssm_state_dim
