"""The gradient of the port's SSD scan on the CPU: the plain backward
(``ssd_chunked_bwd``, the backward kernels' plain version) against
``jax.vjp`` of the reference's ``repro.models.ssm.ssd_chunked`` on the same
numpy inputs, with cotangents on y and on the final state, for x, dt, A, B,
C and the initial state, within 2e-5 x max(1, max|ref|) in f32;
``SSDScanFn`` on CPU tensors against autograd of the plain ``ssd_chunked``;
``ssd`` under grad off the CPU (a meta tensor stands in for the card)
reaching ``SSDScanFn``; the route ``ssd_bwd`` hands the C entry; and the
rounding of both bf16 routes, emulated in plain PyTorch (the state at each
chunk start as the forward's tensor-core route writes it; the scalar
kernels round dx, dB and dC, the tensor-core kernels also their products'
operands, ``ssd_tensor_core_bwd_emulation``), within ``SSD_BWD_BF16_REL``
of the f32 backward, the limit ``chip_smoke.py`` holds the kernels to.
Several groups of B and C: the plain backward against ``jax.vjp`` at G = 2,
G = H and an odd number of heads per group (dB and dC summed over each
group's heads), ``SSDScanFn`` on the CPU, both bf16 emulations within the
limit of the JAX gradient, and what the C entries get (G, the heads per
block, the partials' blocks). The kernels themselves are held against the
plain backward on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` (marked ``cuda``).

The reference has no gradient of its Pallas scan and trains on its plain
``ssd_chunked`` under XLA's autodiff, so that is the oracle."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as js  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import SSD_BWD_BF16_REL, SSDScanFn, ssd, ssd_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked,
    ssd_chunked_bwd,
    ssd_tensor_core_bwd_emulation,
    ssd_tensor_core_states,
)

GRAD_TOL = 2e-5  # x max(1, max|ref|), f32
NAMES = ("x", "dt", "A", "B", "C", "init_state")

# (B, L, H, P, N, chunk, initial state)
CASES = {
    "sweep-p64-n32-q64": (2, 256, 4, 64, 32, 64, False),
    "ragged-p32-n16-q32-init": (1, 100, 2, 32, 16, 32, True),
    "l-below-q-p16-n32-init": (2, 50, 3, 16, 32, 128, True),
    "h1-p16-n128-ragged-init": (1, 300, 1, 16, 128, 128, True),
    "p16-n64-q128": (2, 128, 8, 16, 64, 128, False),
    "p64-n64-q48-ragged-init": (1, 200, 2, 64, 64, 48, True),
    "tiny-l5-init": (1, 5, 2, 32, 16, 128, True),
}
# shapes the tensor-core route takes in bf16: every Q, P and N of it, with
# and without an initial state and a ragged L
ROUTE_CASES = {
    "q64-p64-n32": (2, 256, 4, 64, 32, 64, False),
    "q64-p32-n128-ragged-init": (1, 200, 3, 32, 128, 64, True),
    "q64-p64-n64-init": (1, 128, 2, 64, 64, 64, True),
    "q128-p32-n32": (1, 256, 2, 32, 32, 128, False),
    "q128-p64-n64-ragged-init": (2, 300, 2, 64, 64, 128, True),
    "q128-p64-n128-ragged": (1, 300, 2, 64, 128, 128, False),
}
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _inputs(rng, b, l, h, p, n):
    """x, dt, A, B, C, the initial state and both cotangents (f32), with the
    distributions of tests/test_torch_ssm.py."""
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, l, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 4.0, (h,))).astype(np.float32)
    Bm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0, dy, dfinal


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got.detach().float().numpy() - ref).max())
    assert err <= GRAD_TOL * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_vjp(case, rng):
    """Every input's gradient, the initial state's included (the gradient of
    a zero initial state where the scan starts from none)."""
    b, l, h, p, n, chunk, with_s0 = CASES[case]
    x, dt, A, Bm, Cm, s0, dy, dfinal = _inputs(rng, b, l, h, p, n)
    if not with_s0:
        s0 = np.zeros_like(s0)
    q = min(chunk, l)

    def f(x, dt, A, B, C, s0):
        return js.ssd_chunked(x, dt, A, B[:, :, None], C[:, :, None], q, s0)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, Bm, Cm, s0)))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    tx, tdt, tA, tB, tC, ts0, tdy, tdf = _t(x, dt, A, Bm, Cm, s0, dy, dfinal)
    got = ssd_chunked_bwd(tx, tdt, tA, tB, tC, q, ts0 if with_s0 else None, None, tdy, tdf)
    assert got[0].shape == tx.shape and got[1].shape == tdt.shape and got[2].shape == tA.shape
    assert got[3].shape == tB.shape and got[5].shape == ts0.shape
    for name, g, r in zip(NAMES, got, ref, strict=True):
        _close(g, r, name)
    # given the state at every chunk start, as the kernels get it from the
    # forward (here the final state of the plain scan over each prefix): the same
    init = ts0 if with_s0 else None
    s_in = torch.stack([ts0 if with_s0 else torch.zeros_like(ts0)] + [
        ssd_chunked(tx[:, :c * q], tdt[:, :c * q], tA, tB[:, :c * q, None], tC[:, :c * q, None],
                    q, init)[1] for c in range(1, -(-l // q))], dim=1)
    got = ssd_chunked_bwd(tx, tdt, tA, tB, tC, q, init, s_in, tdy, tdf)
    for name, g, r in zip(NAMES, got, ref, strict=True):
        _close(g, r, name)


@pytest.mark.parametrize("with_s0,with_dfinal", [(True, True), (False, False), (True, False)])
def test_ssd_scan_fn_on_cpu_matches_autograd_of_the_plain_scan(with_s0, with_dfinal, rng):
    """`SSDScanFn` on CPU tensors (`ssd_chunked` forward, `ssd_chunked_bwd`
    backward) against autograd of the plain scan: the same y and final
    state, and every gradient, with and without a loss on the final state
    (its gradient then reaches the backward as None)."""
    b, l, h, p, n, chunk = 2, 100, 3, 16, 32, 32
    x, dt, A, Bm, Cm, s0, dy, dfinal = _inputs(rng, b, l, h, p, n)
    leaves = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm, s0)]
    tdy, tdf = _t(dy, dfinal)
    init = leaves[5] if with_s0 else None

    def loss(y, fs):
        return (y * tdy).sum() + ((fs * tdf).sum() if with_dfinal else 0.0)

    y, fs = ssd_chunked(*leaves[:3], leaves[3][:, :, None], leaves[4][:, :, None], chunk, init)
    wrt = leaves if with_s0 else leaves[:5]
    ref = torch.autograd.grad(loss(y, fs), wrt)
    y2, fs2 = SSDScanFn.apply(*leaves[:5], init, chunk, None)
    assert torch.equal(y2, y) and torch.equal(fs2, fs)
    got = torch.autograd.grad(loss(y2, fs2), wrt)
    for name, g, r in zip(NAMES[:len(wrt)], got, ref, strict=True):
        _close(g, r.numpy(), name)


def test_ssd_bwd_on_cpu_is_the_plain_backward(rng):
    """The wrapper's CPU path: `ssd_chunked_bwd` at q = min(chunk, L), the
    states recomputed where none are given, dinit left out on request."""
    b, l, h, p, n = 1, 40, 2, 16, 16
    x, dt, A, Bm, Cm, s0, dy, dfinal = _t(*_inputs(rng, b, l, h, p, n))
    got = ssd_bwd(x, dt, A, Bm, Cm, None, dy, dfinal, chunk=128, init_state=s0)
    ref = ssd_chunked_bwd(x, dt, A, Bm, Cm, l, s0, None, dy, dfinal)
    assert all(torch.equal(g, r) for g, r in zip(got, ref, strict=True))
    assert ssd_bwd(x, dt, A, Bm, Cm, None, dy, chunk=16, with_dinit=False)[5] is None


def test_ssd_under_grad_off_the_cpu_reaches_the_function(monkeypatch):
    """On a tensor that is not on the CPU (a meta tensor stands in for the
    card), `ssd` with any input requiring grad goes through `SSDScanFn`,
    never the plain scan, and without grad it does not."""
    calls = []

    class Probe:
        @staticmethod
        def apply(*args):
            calls.append(args)
            return "fn"

    def meta(*shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)

    monkeypatch.setattr(ops, "SSDScanFn", Probe)
    monkeypatch.setattr(ops, "ssd_chunked", lambda *a, **k: pytest.fail("plain path"))
    args = [meta(1, 8, 2, 16), meta(1, 8, 2), meta(2), meta(1, 8, 16), meta(1, 8, 16)]
    for i in range(5):
        grad_args = list(args)
        grad_args[i] = meta(*args[i].shape, grad=True)
        assert ssd(*grad_args, chunk=4) == "fn"
    assert ssd(*args, init_state=meta(1, 2, 16, 16, grad=True)) == "fn"
    assert len(calls) == 6 and calls[0][6] == 4  # x, dt, A, B, C, init_state, chunk, kernel
    with torch.no_grad(), pytest.raises(ValueError, match="device"):  # past the grad route
        ssd(*[meta(*a.shape, grad=True) for a in args])
    assert len(calls) == 6


@pytest.mark.parametrize("case", ["sweep-p64-n32-q64", "h1-p16-n128-ragged-init",
                                  "p64-n64-q48-ragged-init"])
def test_bf16_rounding_emulation_is_within_the_limit(case, rng):
    """What the bf16 backward computes on the card, written out: the plain
    backward on bf16 inputs from the state at each chunk start as the
    forward's tensor-core route writes it (its state increments rounded to
    bf16), dx, dB and dC rounded to bf16. Each gradient is within
    `SSD_BWD_BF16_REL` in relative norm of the f32 backward from the true
    states, and the rounded ones read above 1e-4: the route does round."""
    b, l, h, p, n, chunk, with_s0 = CASES[case]
    x, dt, A, Bm, Cm, s0, dy, dfinal = _t(*_inputs(rng, b, l, h, p, n))
    bf = torch.bfloat16
    x, Bm, Cm, dy = (t.to(bf) for t in (x, Bm, Cm, dy))
    s0 = s0 if with_s0 else None
    q = min(chunk, l)
    ref = ssd_chunked_bwd(x.float(), dt, A, Bm.float(), Cm.float(), q, s0, None, dy.float(),
                          dfinal)
    s_in = ssd_tensor_core_states(x, dt, A, Bm, q, s0)
    emu = ssd_chunked_bwd(x, dt, A, Bm, Cm, q, s0, s_in, dy, dfinal)
    assert emu[0].dtype == bf and emu[3].dtype == bf and emu[4].dtype == bf
    for name, e, r in zip(GRADS, emu, ref, strict=True):
        rel = float((e.float() - r).norm() / r.norm())
        assert rel <= SSD_BWD_BF16_REL, (name, rel)
        if name in ("dx", "dB", "dC"):
            assert rel > 1e-4, (name, rel)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_tensor_core_backward_emulation_is_within_the_limit(case, rng):
    """The tensor-core backward's rounding points written out
    (`ssd_tensor_core_bwd_emulation`, after the tensor-core forward's states)
    at every Q, P and N of the route: each gradient within
    `SSD_BWD_BF16_REL` in relative norm of the f32 backward from the exact
    states, and dx, dB, dC and dinit (whose state pass rounds exp(cums) dy)
    above 1e-4: the emulation does round."""
    b, l, h, p, n, chunk, with_s0 = ROUTE_CASES[case]
    x, dt, A, Bm, Cm, s0, dy, dfinal = _t(*_inputs(rng, b, l, h, p, n))
    bf = torch.bfloat16
    x, Bm, Cm, dy = (t.to(bf) for t in (x, Bm, Cm, dy))
    s0 = s0 if with_s0 else None
    assert ops.bwd_route(bf, p, n, chunk, l) == ops.TENSOR_CORE
    ref = ssd_chunked_bwd(x.float(), dt, A, Bm.float(), Cm.float(), chunk, s0, None, dy.float(),
                          dfinal)
    emu = ssd_tensor_core_bwd_emulation(x, dt, A, Bm, Cm, chunk, s0, None, dy, dfinal)
    given = ssd_tensor_core_bwd_emulation(x, dt, A, Bm, Cm, chunk, s0,
                                          ssd_tensor_core_states(x, dt, A, Bm, chunk, s0), dy,
                                          dfinal)
    assert all(torch.equal(e, g) for e, g in zip(emu, given, strict=True))  # None: those states
    assert emu[0].dtype == bf and emu[3].dtype == bf and emu[4].dtype == bf
    for name, e, r in zip(GRADS, emu, ref, strict=True):
        rel = float((e.float() - r).norm() / r.norm())
        assert rel <= SSD_BWD_BF16_REL, (name, rel)
        if name in ("dx", "dB", "dC", "dinit"):
            assert rel > 1e-4, (name, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_backward_takes_the_route_of_its_chunk(dtype, monkeypatch):
    """`ssd_bwd` off the CPU (meta tensors stand in for the card, the C entry
    replaced by a recorder) hands the C entry the route `route` gives its
    chunk min(chunk, L), for every shape of `CASES` and `ROUTE_CASES`, and
    counts it; `kernel="scalar"` forces the scalar kernels, and the
    tensor-core route refuses a call it cannot take."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(ops, "_check_args", lambda k, x, dt, A, Bm, Cm, chunk: (
        *x.shape, Bm.shape[-1], 1))
    monkeypatch.setattr(ops, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(ops, "ptr", lambda t: 0)
    monkeypatch.setattr(ops, "stream_ptr", lambda d: 0)
    monkeypatch.setattr(ops, "_head_group", lambda *a: 8)
    monkeypatch.setattr(ops, "_bwd_fn", lambda: entry)

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, device="meta", dtype=dt)

    for b, l, h, p, n, chunk, _ in [*CASES.values(), *ROUTE_CASES.values()]:
        q = min(chunk, l)
        args = (meta(b, l, h, p, dt=dtype), meta(b, l, h), meta(h), meta(b, l, n, dt=dtype),
                meta(b, l, n, dt=dtype), meta(b, -(-l // q), h, p, n), meta(b, l, h, p, dt=dtype))
        for kernel in (None, ops.SCALAR):
            want = ops.route(dtype, p, n, q) if kernel is None else ops.SCALAR
            before = dict(ssd_bwd.route_launches)
            ssd_bwd(*args, chunk=chunk, kernel=kernel)
            assert calls[-1][24] == q and calls[-1][-2] == ops._ROUTE_CODE[want], (b, l, p, n)
            assert ssd_bwd.route_launches[want] == before[want] + 1
        if ops.route(dtype, p, n, q) == ops.SCALAR:
            with pytest.raises(ValueError, match="tensor_core route does not take"):
                ssd_bwd(*args, chunk=chunk, kernel=ops.TENSOR_CORE)
    routes = {c[-2] for c in calls}
    assert routes == ({0, 1} if dtype == torch.bfloat16 else {0})


def test_the_profile_files_the_ssd_kernels_under_their_own_groups():
    """`launch.profile.kernel_group` splits the SSD scan's forward and
    backward kernels out of "other", and none of their names carries a key
    of another group."""
    from repro_torch.launch.profile import kernel_group

    ns = "void (anonymous namespace)::"
    for name in ("ssd_state_pass<128, 64, 64>", "tc::ssd_chunk_out<128, 64, 64>",
                 "ssd_scan_kernel<float, 64, 64>"):
        assert kernel_group(ns + name + "(...)") == "ssd_scan", name
    for name in ("ssd_state_bwd<__nv_bfloat16, 64, 64>", "ssd_chunk_bwd<float, 16, 128>",
                 "ssd_bwd_reduce<__nv_bfloat16>", "tc::ssd_state_bwd_wgmma<128, 64, 64>",
                 "tc::ssd_chunk_bwd_wgmma<64, 32, 128>"):
        assert kernel_group(ns + name + "(...)") == "ssd_scan_bwd", name


# ------------------------------------------------ several groups of B and C

# (B, L, H, P, N, chunk, G, initial state): two groups, one head a group, 3
# heads a group (odd), 2 heads a group with L below one chunk
GROUP_CASES = {
    "g2-ragged-init": (2, 100, 4, 16, 16, 32, 2, True),
    "g-equals-h": (1, 90, 4, 32, 16, 32, 4, False),
    "rep3-init": (2, 70, 6, 16, 32, 32, 2, True),
    "rep2-l-below-q-init": (1, 50, 6, 16, 16, 64, 3, True),
}
# the tensor-core route's shapes at G > 1: N = 64 and N = 128 (its split passes)
GROUP_ROUTE_CASES = {
    "q128-p64-n64-g2-init": (2, 300, 4, 64, 64, 128, 2, True),
    "q64-p32-n128-rep3": (1, 200, 6, 32, 128, 64, 2, False),
    "q128-p64-n32-g-equals-h-init": (1, 150, 4, 64, 32, 128, 4, True),
}


def _grouped(rng, b, l, h, p, n, g):
    x, dt, A, _, _, s0, dy, dfinal = _inputs(rng, b, l, h, p, n)
    Bm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm, s0, dy, dfinal


def _jax_grads(x, dt, A, Bm, Cm, s0, dy, dfinal, q):
    _, vjp = jax.vjp(lambda *a: js.ssd_chunked(*a[:5], q, a[5]),
                     *map(jnp.asarray, (x, dt, A, Bm, Cm, s0)))
    return vjp((jnp.asarray(dy), jnp.asarray(dfinal)))


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_grouped_plain_backward_matches_jax_vjp(case, rng):
    """Every gradient at G > 1, dB and dC (B, L, G, N) each group's sum over
    its heads, from recomputed states and from given ones."""
    b, l, h, p, n, chunk, g, with_s0 = GROUP_CASES[case]
    x, dt, A, Bm, Cm, s0, dy, dfinal = _grouped(rng, b, l, h, p, n, g)
    if not with_s0:
        s0 = np.zeros_like(s0)
    q = min(chunk, l)
    ref = _jax_grads(x, dt, A, Bm, Cm, s0, dy, dfinal, q)
    tx, tdt, tA, tB, tC, ts0, tdy, tdf = _t(x, dt, A, Bm, Cm, s0, dy, dfinal)
    init = ts0 if with_s0 else None
    got = ssd_chunked_bwd(tx, tdt, tA, tB, tC, q, init, None, tdy, tdf)
    assert got[3].shape == tB.shape and got[4].shape == tC.shape
    for name, gr, r in zip(NAMES, got, ref, strict=True):
        _close(gr, r, name)
    s_in = torch.stack([ts0 if with_s0 else torch.zeros_like(ts0)] + [
        ssd_chunked(tx[:, :c * q], tdt[:, :c * q], tA, tB[:, :c * q], tC[:, :c * q], q, init)[1]
        for c in range(1, -(-l // q))], dim=1)
    got = ssd_chunked_bwd(tx, tdt, tA, tB, tC, q, init, s_in, tdy, tdf)
    for name, gr, r in zip(NAMES, got, ref, strict=True):
        _close(gr, r, name)


def test_grouped_ssd_scan_fn_on_cpu_matches_autograd_of_the_plain_scan(rng):
    b, l, h, p, n, chunk, g = 2, 100, 6, 16, 32, 32, 2
    x, dt, A, Bm, Cm, s0, dy, dfinal = _grouped(rng, b, l, h, p, n, g)
    leaves = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm, s0)]
    tdy, tdf = _t(dy, dfinal)

    def loss(y, fs):
        return (y * tdy).sum() + (fs * tdf).sum()

    ref = torch.autograd.grad(loss(*ssd_chunked(*leaves[:5], chunk, leaves[5])), leaves)
    got = torch.autograd.grad(loss(*SSDScanFn.apply(*leaves, chunk, None)), leaves)
    for name, gr, r in zip(NAMES, got, ref, strict=True):
        assert gr.shape == r.shape
        _close(gr, r.numpy(), name)


@pytest.mark.parametrize("case", list(GROUP_ROUTE_CASES))
def test_grouped_bf16_emulations_are_within_the_limit_of_jax(case, rng):
    """Both bf16 routes' rounding written out at G > 1 (the scalar kernels
    from the tensor-core forward's states; the tensor-core kernels' operands
    too): every gradient within `SSD_BWD_BF16_REL` in relative norm of the
    JAX gradient in f32 on the same bf16 values."""
    b, l, h, p, n, chunk, g, with_s0 = GROUP_ROUTE_CASES[case]
    x, dt, A, Bm, Cm, s0, dy, dfinal = _grouped(rng, b, l, h, p, n, g)
    bf = torch.bfloat16
    x, Bm, Cm, dy = (torch.from_numpy(a).to(bf) for a in (x, Bm, Cm, dy))
    s0 = s0 if with_s0 else np.zeros_like(s0)
    ref = _jax_grads(x.float().numpy(), dt, A, Bm.float().numpy(), Cm.float().numpy(), s0,
                     dy.float().numpy(), dfinal, chunk)
    tdt, tA, ts0, tdf = _t(dt, A, s0, dfinal)
    init = ts0 if with_s0 else None
    assert ops.bwd_route(bf, p, n, chunk, l) == ops.TENSOR_CORE
    s_in = ssd_tensor_core_states(x, tdt, tA, Bm, chunk, init)
    for emu in (ssd_chunked_bwd(x, tdt, tA, Bm, Cm, chunk, init, s_in, dy, tdf),
                ssd_tensor_core_bwd_emulation(x, tdt, tA, Bm, Cm, chunk, init, None, dy, tdf)):
        assert emu[3].shape == Bm.shape and emu[3].dtype == bf
        for name, e, r in zip(GRADS, emu, ref, strict=True):
            r = np.asarray(r, np.float32)
            rel = float(np.linalg.norm(e.float().numpy() - r) / np.linalg.norm(r))
            assert rel <= SSD_BWD_BF16_REL, (name, rel)


@pytest.mark.parametrize("g", [1, 2, 3, 6])
def test_the_c_entries_get_the_groups(g, monkeypatch):
    """Forward and backward off the CPU (meta tensors stand in for the card,
    the C entries replaced by recorders, 132 SMs) hand the C entries G,
    heads per block within one group, and partials of G ceil(rep / hg)
    blocks a chunk; the block rule at G = 1 is the one-group rule."""
    fwd, bwd = [], []

    class Lib:
        @staticmethod
        def repro_ssd_scan(*args):
            fwd.append(args)
            return 0

    def entry(*args):
        bwd.append(args)
        return 0

    monkeypatch.setattr(ops, "_check_args", lambda k, x, dt, A, Bm, Cm, chunk: (
        *x.shape, Bm.shape[-1], ops._groups(Bm)))
    monkeypatch.setattr(ops, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(ops, "ptr", lambda t: t.shape)  # the scratch's shape, for the check
    monkeypatch.setattr(ops, "stream_ptr", lambda d: 0)
    monkeypatch.setattr(ops, "_lib", lambda: Lib)
    monkeypatch.setattr(ops, "_bwd_fn", lambda: entry)
    monkeypatch.setitem(ops._sms, None, 132)

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, device="meta", dtype=dt)

    bf = torch.bfloat16
    for b, l, h, chunk in ((4, 2048, 6, 128), (1, 300, 6, 64), (2, 64, 12, 64)):
        p, n, q = 64, 64, min(chunk, l)
        nc = -(-l // q)
        args = (meta(b, l, h, p, dt=bf), meta(b, l, h), meta(h), meta(b, l, g, n, dt=bf),
                meta(b, l, g, n, dt=bf))
        with torch.no_grad():
            ops.ssd(*args, chunk=chunk)
        assert fwd[-1][12] == g and fwd[-1][11] == h
        ops.ssd_bwd(*args, meta(b, nc, h, p, n), meta(b, l, h, p, dt=bf), chunk=chunk)
        call = bwd[-1]
        assert call[20] == h and call[21] == g
        hg, rep = call[25], h // g
        assert 1 <= hg <= rep
        assert call[15] == (b, nc, g * -(-rep // hg), q, n)  # the dB partials
        if g == 1:  # the one-group rule: 8 heads, halved while the grid leaves SMs idle
            old = 8
            while old > 1 and -(-h // old) * nc * b < 132:
                old //= 2
            assert -(-h // hg) == -(-h // old)
