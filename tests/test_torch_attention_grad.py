"""The gradient of the port's prefill attention on the CPU: the plain
backward (``prefill_attention_bwd_ref``, the backward kernels' plain
version) against ``jax.vjp`` of the reference's own plain attention
(``repro.models.layers.naive_attention`` under ``attention_mask``, and
``blockwise_attention`` for one large case) on the same numpy inputs, within
2e-5 x max(1, max|ref|) in f32; ``PrefillAttentionFn`` on CPU tensors
against autograd of ``prefill_attention_ref``; the bf16 backward kernels'
rounding points emulated in plain PyTorch (P and dS rounded to bf16, every
sum in f32) within the 1e-2 relative norm that ``chip_smoke.py`` holds the
kernels to (``BWD_BF16_REL``), against the f32 plain backward and against
``jax.vjp`` of the reference's naive attention, at every head dim, with and
without a cap; and the wrappers' grad check (a kernel writes into a fresh
tensor autograd cannot see through, so every wrapper refuses an input that
requires grad outside its autograd Function).

The reference cannot differentiate its Pallas kernel (``pallas_call`` has no
transpose rule, ROADMAP C8), so its plain attention is the oracle."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.prefill_attention.ops import (  # noqa: E402
    prefill_attention,
    prefill_attention_bwd,
)
from repro_torch.kernels.prefill_attention.ref import (  # noqa: E402
    prefill_attention_bwd_ref,
    prefill_attention_lse,
    prefill_attention_ref,
)
from repro_torch.kernels.sched_scan import ops as sched_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402

# (B, Sq, Skv, Hq, Hkv, Dh, logit cap, ragged kv_len)
CASES = {
    "gqa4-dh64-prefix-ragged": (2, 16, 40, 8, 2, 64, 0.0, True),
    "mha-dh128-cap50": (1, 24, 24, 4, 4, 128, 50.0, False),
    "gqa2-dh256-cap50-prefix-ragged": (2, 12, 30, 4, 2, 256, 50.0, True),
    "gqa4-dh64-whole": (1, 20, 20, 4, 1, 64, 0.0, False),
    "mha-dh64-cap50-prefix": (2, 8, 33, 2, 2, 64, 50.0, False),
}


def _inputs(rng, b, sq, skv, hq, hkv, dh, cap, ragged):
    """q, k, v, dO (f32) and q_pos at the end of a prefix of Skv rows (each
    row its own offset), kv_len cut 3 rows short where ``ragged``."""
    sc = 3.0 if cap else 1.0  # so the cap bites
    q = (sc * rng.standard_normal((b, sq, hq, dh))).astype(np.float32)
    k = (sc * rng.standard_normal((b, skv, hkv, dh))).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, dh)).astype(np.float32)
    offs = np.array([skv - sq, *rng.integers(0, skv - sq + 1, b - 1)], np.int32)
    q_pos = (offs[:, None] + np.arange(sq, dtype=np.int32)[None]).astype(np.int32)
    kv_len = (offs + sq - (3 if ragged else 0)).astype(np.int32)
    return q, k, v, do, q_pos, kv_len


def _tol_check(got, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    lim = 2e-5 * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, f"{what}: max abs err {err:.3e} beyond {lim:.3e}"


def _port_bwd(q, k, v, do, q_pos, kv_len, cap):
    t = [torch.from_numpy(a) for a in (q, k, v, do, q_pos, kv_len)]
    q_, k_, v_, do_, qp, kl = t
    out = prefill_attention_ref(q_, k_, v_, qp, kl, logit_cap=cap)
    lse = prefill_attention_lse(q_, k_, qp, kl, logit_cap=cap)
    return [g.numpy() for g in prefill_attention_bwd_ref(q_, k_, v_, out, lse, do_, qp, kl,
                                                          logit_cap=cap)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp_of_naive_attention(case, rng):
    b, sq, skv, hq, hkv, dh, cap, ragged = CASES[case]
    q, k, v, do, q_pos, kv_len = _inputs(rng, b, sq, skv, hq, hkv, dh, cap, ragged)
    mask = jl.attention_mask(jnp.asarray(q_pos), skv, jnp.asarray(kv_len), causal=True)

    def f(q, k, v):
        return jl.naive_attention(q, k, v, mask, logit_cap=cap)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _port_bwd(q, k, v, do, q_pos, kv_len, cap)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref, strict=True):
        _tol_check(g, r, f"{case} {name}")


def test_plain_backward_matches_jax_vjp_of_blockwise_attention(rng):
    """A larger case against the reference's blockwise path, over several
    64-row KV blocks: GQA 4:1, cap 50, ragged kv_len."""
    b, sq, skv, hq, hkv, dh, cap = 2, 160, 300, 8, 2, 64, 50.0
    q, k, v, do, q_pos, kv_len = _inputs(rng, b, sq, skv, hq, hkv, dh, cap, True)

    def f(q, k, v):
        return jl.blockwise_attention(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_len), 0, True,
                                      cap, None, kv_block=64)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    got = _port_bwd(q, k, v, do, q_pos, kv_len, cap)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref, strict=True):
        _tol_check(g, r, f"blockwise {name}")


@pytest.mark.parametrize("case", ["gqa4-dh64-prefix-ragged", "gqa2-dh256-cap50-prefix-ragged"])
def test_lse_is_the_log_sum_exp_of_the_reference_scores(case, rng):
    """The log-sum-exp the backward recomputes P from: softmax(s) = exp(s -
    lse) reproduces the reference's output."""
    b, sq, skv, hq, hkv, dh, cap, ragged = CASES[case]
    q, k, v, _, q_pos, kv_len = _inputs(rng, b, sq, skv, hq, hkv, dh, cap, ragged)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_len)]
    lse = prefill_attention_lse(t[0], t[1], t[3], t[4], logit_cap=cap)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    mask = jl.attention_mask(jnp.asarray(q_pos), skv, jnp.asarray(kv_len), causal=True)
    ref = jl.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, logit_cap=cap)
    rep = hq // hkv
    s = torch.einsum("bqhd,bkhd->bhqk", t[0], t[1].repeat_interleave(rep, 2)) / dh ** 0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    m = torch.from_numpy(np.array(mask))[:, None]
    p = torch.where(m, torch.exp(s - lse[..., None]), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, t[2].repeat_interleave(rep, 2))
    _tol_check(out.numpy(), ref, f"{case} softmax from lse")


@pytest.mark.parametrize("case", ["gqa4-dh64-prefix-ragged", "mha-dh128-cap50"])
def test_autograd_function_equals_autograd_of_the_plain_version(case, rng):
    """On CPU tensors that require grad, `prefill_attention` goes through
    PrefillAttentionFn (forward: the plain version and its lse; backward:
    the plain backward), which equals autograd through the plain forward."""
    b, sq, skv, hq, hkv, dh, cap, ragged = CASES[case]
    q, k, v, do, q_pos, kv_len = _inputs(rng, b, sq, skv, hq, hkv, dh, cap, ragged)
    qp, kl, g = torch.from_numpy(q_pos), torch.from_numpy(kv_len), torch.from_numpy(do)
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = prefill_attention(*a, qp, kl, logit_cap=cap)
    assert type(out.grad_fn).__name__ == "PrefillAttentionFnBackward"
    got = torch.autograd.grad(out, a, g)
    r = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref_out = prefill_attention_ref(*r, qp, kl, logit_cap=cap)
    _tol_check(out.detach().numpy(), ref_out.detach().numpy(), f"{case} forward")
    ref = torch.autograd.grad(ref_out, r, g)
    for name, x, y in zip(("dq", "dk", "dv"), got, ref, strict=True):
        _tol_check(x.numpy(), y.numpy(), f"{case} {name}")


# The limit chip_smoke.py holds the bf16 backward kernels to, in relative norm
BWD_BF16_REL = 1e-2


def _bwd_bf16_emulated(q, k, v, out, lse, do, q_pos, kv_len, cap):
    """The bf16 route of csrc/prefill_attention_bwd.cu in plain PyTorch, from
    bf16 inputs: S, dP and D = rowsum(dO * O) in f32, P = exp(s - lse) and
    dS = P (dP - D) (1 - (s / cap)^2), then P and dS rounded to bf16 (the
    register A operands of the wgmma products), dV = P^T dO, dK = scale dS^T
    Q and dQ = scale dS K summed in f32, dK and dV over each group, and the
    results rounded to bf16 as the kernels store them."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    sc = 1.0 / dh ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * sc
    if cap:
        s = cap * torch.tanh(s / cap)
    kvp = torch.arange(skv)
    mask = ((kvp[None, None, :] <= q_pos[:, :, None])
            & (kvp[None, None, :] < kv_len[:, None, None]))[:, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    d = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - d)
    if cap:
        ds = ds * torch.where(mask, 1.0 - (s / cap) ** 2, 0.0)
    p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kr) * sc
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds16, qf) * sc).reshape(b, skv, hkv, rep, dh).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof).reshape(b, skv, hkv, rep, dh).sum(3)
    return [g.to(torch.bfloat16).float() for g in (dq, dk, dv)]


def _rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).norm() / ref.norm())


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("dh", checks.HEAD_DIMS)
def test_bf16_rounding_points_stay_within_the_kernel_limit(dh, cap, rng):
    """The wgmma backward's rounding points (P and dS to bf16 before their
    products, f32 sums, bf16 stores) at GQA 2:1 with ragged prefixes and
    kv_len: within BWD_BF16_REL in relative norm of the f32 plain backward
    from the same bf16 inputs (what chip_smoke.py compares the kernels
    with) and of jax.vjp of the reference's naive attention, and not
    trivially so (the bf16 rounding shows)."""
    b, sq, skv, hq, hkv = 2, 24, 40, 4, 2
    q, k, v, do, q_pos, kv_len = _inputs(rng, b, sq, skv, hq, hkv, dh, cap, True)
    qb, kb, vb, dob = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    qp, kl = torch.from_numpy(q_pos), torch.from_numpy(kv_len)
    out = prefill_attention_ref(qb, kb, vb, qp, kl, logit_cap=cap)  # bf16, as the forward kernel
    lse = prefill_attention_lse(qb, kb, qp, kl, logit_cap=cap)
    got = _bwd_bf16_emulated(qb, kb, vb, out, lse, dob, qp, kl, cap)
    f32 = [t.float() for t in (qb, kb, vb, out, dob)]
    plain = prefill_attention_bwd_ref(f32[0], f32[1], f32[2], f32[3], lse, f32[4], qp, kl,
                                      logit_cap=cap)
    mask = jl.attention_mask(jnp.asarray(q_pos), skv, jnp.asarray(kv_len), causal=True)
    _, vjp = jax.vjp(lambda a, b_, c: jl.naive_attention(a, b_, c, mask, logit_cap=cap),
                     *(jnp.asarray(t.numpy()) for t in f32[:3]))
    ref = vjp(jnp.asarray(f32[4].numpy()))
    for name, g, p_, r in zip(("dq", "dk", "dv"), got, plain, ref, strict=True):
        rel_plain, rel_jax = _rel(g, p_), _rel(g, r)
        assert rel_plain <= BWD_BF16_REL and rel_jax <= BWD_BF16_REL, (
            f"Dh={dh} cap={cap} {name}: relative error {rel_plain:.3e} (plain f32), "
            f"{rel_jax:.3e} (jax.vjp) beyond {BWD_BF16_REL}")
        assert rel_plain > 1e-4, f"Dh={dh} cap={cap} {name}: no bf16 rounding seen"


def test_serving_path_takes_no_autograd_function(rng):
    """Without grad the wrapper returns the plain version's result as it
    always has: no Function, no log-sum-exp."""
    q, k, v, _, q_pos, kv_len = _inputs(rng, *CASES["gqa4-dh64-whole"])
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = prefill_attention(*t, torch.from_numpy(q_pos), torch.from_numpy(kv_len))
    assert out.grad_fn is None
    plain = prefill_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(q_pos), torch.from_numpy(kv_len))
    assert torch.equal(out, plain) and plain.grad_fn is None


# ------------------------------------------------------------- the grad check

def test_check_no_grad_logic():
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    checks.check_no_grad("k", "why", a=y, b=None)  # nothing requires grad
    with torch.no_grad():
        checks.check_no_grad("k", "why", a=x)  # grad mode off
    with pytest.raises(RuntimeError, match=r"k: a requires grad.*\(why\)"):
        checks.check_no_grad("k", "why", a=x)

    class Fn(torch.autograd.Function):  # a call through an autograd Function passes
        @staticmethod
        def forward(ctx, t):
            checks.check_no_grad("k", "why", t=t)
            return t * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    Fn.apply(x).sum().backward()
    assert torch.equal(x.grad, torch.full((2,), 2.0))


def _meta(*shape, grad=True, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


def _i32(*shape):
    return torch.zeros(shape, device="meta", dtype=torch.int32)


WRAPPERS = {
    "decode_attention": (
        lambda: decode_attention(_meta(1, 4, 16), _meta(1, 8, 2, 16), _meta(1, 8, 2, 16),
                                 _i32(1)), "decode_attention: q requires grad"),
    "ssd_scan": (
        lambda: ssd(_meta(1, 8, 2, 16), _meta(1, 8, 2), _meta(2), _meta(1, 8, 16),
                    _meta(1, 8, 16)), "ssd_scan: x requires grad.*A10b"),
    "prefill_attention_bwd": (
        lambda: prefill_attention_bwd(
            _meta(1, 4, 2, 16), _meta(1, 4, 2, 16), _meta(1, 4, 2, 16), _meta(1, 4, 2, 16),
            _meta(1, 2, 4), _meta(1, 4, 2, 16), _i32(1, 4), _i32(1)),
        "prefill_attention_bwd: q requires grad.*no double backward"),
    "fcfs_scan": (
        lambda: sched_ops.fcfs_scan(_meta(4), _meta(4), _meta(1)),
        "sched_scan.fcfs_scan: a_s requires grad"),
    "slack_pack": (
        lambda: sched_ops.slack_pack(_i32(4), _meta(4, grad=False, dtype=torch.bool), _meta(1),
                                     _meta(2, 2), _i32(2), _i32(2)),
        "sched_scan.slack_pack: s_min requires grad"),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_every_kernel_wrapper_refuses_an_input_that_requires_grad(name, monkeypatch):
    """Off the CPU (here a meta tensor stands in for the card: the check runs
    before any launch), each wrapper raises naming itself instead of
    returning a tensor without grad_fn. The scheduler wrappers refuse any
    device but the CPU and CUDA first, so they are told the tensor is not on
    the CPU."""
    call, msg = WRAPPERS[name]
    if name in ("fcfs_scan", "slack_pack"):
        monkeypatch.setattr(sched_ops, "_on_cpu", lambda name, t: False)
    with pytest.raises(RuntimeError, match=msg):
        call()
    if name not in ("fcfs_scan", "slack_pack"):
        with torch.no_grad(), pytest.raises(ValueError, match="device"):  # past the check
            call()
