"""The port on the card: the kernel wrappers' argument checks (attention
and SSD scan) and grad checks, a small serve whose attention goes through
the kernels, the prefill backward kernels and a small train step against
the CPU. The kernels themselves are
held against their plain versions on the card by ``chip_smoke.py`` alone
(the sweep of tests/test_kernels.py and the serving shapes). Every test is
marked ``cuda`` and skips without a card; this file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.prefill_attention.ops import prefill_attention  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import DisaggServer, EngineConfig, reference_generate  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 24, device=cuda)  # head_dim 24 is not built
    k = torch.zeros(1, 8, 2, 24, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device=cuda))
    q = torch.zeros(1, 4, 32, device=cuda)
    k = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int64, device=cuda))
    strided = torch.zeros(1, 2, 8, 32, device=cuda).transpose(1, 2)  # (1, 8, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, strided, k, torch.ones(1, dtype=torch.int32, device=cuda))


def test_attention_wrappers_reject_what_the_redesigned_kernels_do_not_take(cuda):
    """The wgmma prefill kernel takes bf16 at the head dims it is built for
    (f32 goes to the scalar kernel, nothing else anywhere); the split-KV
    decode kernel takes at most 16 query heads per KV head and a cache of at
    least one row."""
    pos = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    kvl = torch.ones(1, dtype=torch.int32, device=cuda)
    for dh in (24, 96, 192):  # bf16 head dims outside HEAD_DIMS
        q = torch.zeros(1, 8, 4, dh, device=cuda, dtype=torch.bfloat16)
        k = torch.zeros(1, 8, 2, dh, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            prefill_attention(q, k, k, pos, kvl)
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        prefill_attention(q, q[:, :, :2], q[:, :, :2], pos, kvl)
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtypes differ"):
        prefill_attention(q, k.float(), k, pos, kvl)
    with pytest.raises(ValueError, match="int32"):
        prefill_attention(q, k, k, pos.long(), kvl)
    with pytest.raises(ValueError, match="multiple"):
        prefill_attention(torch.zeros(1, 8, 3, 64, device=cuda, dtype=torch.bfloat16), k, k,
                          pos, kvl)
    qd = torch.zeros(1, 32, 64, device=cuda, dtype=torch.bfloat16)  # 32 query heads per KV head
    kd = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most"):
        decode_attention(qd, kd, kd, kvl)
    with pytest.raises(ValueError, match="no rows"):
        decode_attention(qd[:, :4], kd[:, :0], kd[:, :0], kvl)
    n0 = (prefill_attention.launches, decode_attention.launches)
    prefill_attention(q, k, k, pos, kvl)
    decode_attention(qd[:, :4].contiguous(), kd, kd, kvl)
    assert (prefill_attention.launches, decode_attention.launches) == (n0[0] + 1, n0[1] + 1)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    def args(b=1, l=40, h=2, p=16, n=16, dtype=torch.float32):
        return [torch.zeros(b, l, h, p, device=cuda, dtype=dtype),
                torch.zeros(b, l, h, device=cuda), -torch.ones(h, device=cuda),
                torch.zeros(b, l, n, device=cuda, dtype=dtype),
                torch.zeros(b, l, n, device=cuda, dtype=dtype)]

    with pytest.raises(ValueError, match="head_dim"):
        ssd(*args(p=24))
    with pytest.raises(ValueError, match="state_dim"):
        ssd(*args(n=8))
    with pytest.raises(ValueError, match="chunk"):
        ssd(*args(), chunk=256)
    x, dt, A, Bm, Cm = args()
    with pytest.raises(ValueError, match="float32"):
        ssd(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(ValueError, match="dtypes differ"):
        ssd(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="init_state"):
        ssd(x, dt, A, Bm, Cm, init_state=torch.zeros(1, 2, 16, 8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="is on"):
        ssd(x, dt.cpu(), A, Bm, Cm)
    n0 = ssd.launches
    y, fs = ssd(x, dt, A, Bm, Cm, chunk=16)
    assert ssd.launches == n0 + 1 and y.shape == x.shape and fs.shape == (1, 2, 16, 16)


def test_ssd_routes_and_their_argument_checks(cuda):
    """bf16 at a route shape takes the tensor-core route, other shapes and
    f32 the scalar kernel; forcing the tensor-core route where it does not
    apply raises, and each call counts once, under its route."""
    from repro_torch.kernels.ssd_scan.ops import SCALAR, TENSOR_CORE

    def args(dtype, p=64, n=64, b=1, l=100, h=2):
        return [torch.randn(b, l, h, p, device=cuda).to(dtype),
                torch.full((b, l, h), 0.01, device=cuda), -torch.ones(h, device=cuda),
                torch.randn(b, l, n, device=cuda).to(dtype),
                torch.randn(b, l, n, device=cuda).to(dtype)]

    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="tensor_core route does not take"):
        ssd(*args(torch.float32), kernel=TENSOR_CORE)
    with pytest.raises(ValueError, match="tensor_core route does not take"):
        ssd(*args(bf16), chunk=32, kernel=TENSOR_CORE)
    with pytest.raises(ValueError, match="tensor_core route does not take"):
        ssd(*args(bf16, p=16), kernel=TENSOR_CORE)
    before = dict(ssd.route_launches)
    n0 = ssd.launches
    y, fs = ssd(*args(bf16), chunk=64)  # L = 100: a whole chunk and a ragged one
    ssd(*args(bf16, n=16))
    ssd(*args(bf16), kernel=SCALAR)
    torch.cuda.synchronize()
    assert y.shape == (1, 100, 2, 64) and fs.shape == (1, 2, 64, 64)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(fs).all())
    assert ssd.launches == n0 + 3
    assert ssd.route_launches[TENSOR_CORE] == before[TENSOR_CORE] + 1
    assert ssd.route_launches[SCALAR] == before[SCALAR] + 2


@pytest.mark.parametrize("page_size", [None, 8])
def test_small_serve_goes_through_the_kernels(cuda, page_size, rng):
    """A tiny f32 model served on the card: tokens equal reference_generate's
    and both kernels launched."""
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    prompts = [list(map(int, rng.integers(2, cfg.vocab_size, n))) for n in (5, 19, 40)]
    reqs = [(Request(rid=i, arrival=0.0, input_len=len(p), output_len=6,
                     slo=SLOSpec(ttft=60.0, tpot=5.0)), p) for i, p in enumerate(prompts)]
    n_pre, n_dec = prefill_attention.launches, decode_attention.launches
    outs = DisaggServer(model, params, EngineConfig(max_slots=4, max_len=64, chunk_size=16,
                                                    page_size=page_size),
                        device=cuda).serve(reqs)
    assert prefill_attention.launches > n_pre and decode_attention.launches > n_dec
    for i, p in enumerate(prompts):
        assert outs[i] == reference_generate(model, params, p, 6, 64)


def test_spans_read_the_stream_on_the_card(cuda, rng):
    """A traced serve on the card: every device phase of each decode step
    and every prefill chunk has a positive time on the stream, the wait has
    none, and a step's gather and scatter together take at most the step's
    stream time (its four device phases)."""
    from repro_torch.obs.events import TraceRecorder
    from repro_torch.serving.session import ServeSession

    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    prompts = [list(map(int, rng.integers(2, cfg.vocab_size, n))) for n in (5, 19, 40)]
    reqs = [(Request(rid=i, arrival=0.0, input_len=len(p), output_len=6,
                     slo=SLOSpec(ttft=60.0, tpot=5.0)), p) for i, p in enumerate(prompts)]
    trace = TraceRecorder()
    srv = DisaggServer(model, params, EngineConfig(max_slots=4, max_len=64, chunk_size=16,
                                                   page_size=8), device=cuda)
    ServeSession(srv, trace=trace).run(reqs)
    chunks = [s for s in trace.spans if s.name == "prefill.chunk"]
    dec = [s for s in trace.spans if s.name.startswith("decode.")]
    assert chunks and dec and len(dec) % 5 == 0
    assert all(s.device_s > 0 for s in chunks)
    for i in range(0, len(dec), 5):
        gather, forward, scatter, samp, wait = dec[i:i + 5]
        assert wait.name == "decode.wait" and wait.device_s is None
        stream = [gather.device_s, forward.device_s, scatter.device_s, samp.device_s]
        assert all(d > 0 for d in stream)
        assert gather.device_s + scatter.device_s <= sum(stream)


# bf16 against the plain version computed in f32 from the same inputs, in
# relative norm (decode lane by lane), as chip_smoke.py holds them: the 2e-2
# elementwise tolerance is as large as a typical output over a few hundred rows
# (the limits are about twice chip_smoke.py's largest readings on an H100)
BF16_PREFILL_REL = 6e-3
BF16_DECODE_REL = 6e-3


def _softmax_pv_f32(s, mask, v, spec):
    """softmax of the masked f32 scores, P rounded to bf16 as the kernels
    round it, times v in f32."""
    from repro_torch.kernels.prefill_attention.ref import NEG_INF

    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum(spec, p.to(torch.bfloat16).float(), v.float())


def _capped(s, cap):
    return cap * torch.tanh(s / cap) if cap else s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_kernels_match_their_plain_versions(cuda, dtype):
    """gemma2's head dim in both attention kernels (bf16 prefill on wgmma at
    32-row KV tiles, f32 decode at a 3-slot ring), logit cap 50 included:
    within 2e-5 (f32) or 2e-2 (bf16) of the plain versions, and bf16 within
    the relative-norm limits of the plain versions in f32."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

    tol = 2e-5 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dtype)

    b, sq, skv, hq, hkv = 2, 100, 300, 16, 8
    q, k, v = randn(b, sq, hq, 256, scale=3.0), randn(b, skv, hkv, 256, scale=3.0), randn(b, skv, hkv, 256)
    kv_len = torch.tensor([300, 170], dtype=torch.int32, device=cuda)
    q_pos = (kv_len[:, None] - sq + torch.arange(sq, device=cuda, dtype=torch.int32)).contiguous()
    for cap in (0.0, 50.0):
        out = prefill_attention(q, k, v, q_pos, kv_len, logit_cap=cap)
        ref = prefill_attention_ref(q, k, v, q_pos, kv_len, logit_cap=cap)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        qd = q[:, 0].contiguous()
        outd = decode_attention(qd, k, v, kv_len, logit_cap=cap)
        ref = decode_attention_ref(qd, k, v, kv_len, logit_cap=cap)
        torch.testing.assert_close(outd.float(), ref.float(), rtol=tol, atol=tol)
        if dtype != torch.bfloat16:
            continue
        kvp = torch.arange(skv, device=cuda)
        kf = k.float().repeat_interleave(hq // hkv, dim=2)
        vf = v.float().repeat_interleave(hq // hkv, dim=2)
        s = _capped(torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / 16.0, cap)
        mask = (kvp[None, None, :] <= q_pos[:, :, None]) & (kvp[None, None, :] < kv_len[:, None, None])
        ref32 = _softmax_pv_f32(s, mask[:, None], vf, "bhqk,bkhd->bqhd")
        rel = float((out.float() - ref32).norm() / ref32.norm())
        assert rel <= BF16_PREFILL_REL, f"prefill cap {cap}: relative error {rel:.3e}"
        s = _capped(torch.einsum("bhd,bkhd->bhk", qd.float(), kf) / 16.0, cap)
        mask = kvp[None, None, :] < kv_len[:, None, None]
        ref32 = _softmax_pv_f32(s, mask, vf, "bhk,bkhd->bhd")
        lanes = (outd.float() - ref32).flatten(1).norm(dim=1) / ref32.flatten(1).norm(dim=1)
        assert float(lanes.max()) <= BF16_DECODE_REL, f"decode cap {cap}: lanes {lanes.tolist()}"


def test_sched_scan_kernels_equal_their_plain_versions(cuda):
    """Both scheduler scans bit for bit against their plain versions, over
    more slots than one tile (2048), with ties in the keys; the wrappers
    refuse what the kernels do not take."""
    from repro_torch.kernels.sched_scan.ops import fcfs_scan, slack_pack
    from repro_torch.kernels.sched_scan.ref import fcfs_scan_ref, slack_pack_ref

    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 5000
    a = torch.sort(torch.randint(0, 400, (n,), generator=gen, device=cuda).float() / 32).values
    d = torch.rand(n, generator=gen, device=cuda) * 0.01
    t0 = torch.tensor([1.5], device=cuda)
    n0 = (fcfs_scan.launches, slack_pack.launches)
    assert torch.equal(fcfs_scan(a, d, t0), fcfs_scan_ref(a, d, t0))
    seq = torch.sort(torch.randint(64, 300_000, (n,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    act = torch.rand(n, generator=gen, device=cuda) < 0.9
    be = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128, 256], dtype=torch.int32, device=cuda)
    se = torch.tensor([512 << i for i in range(10)], dtype=torch.int32, device=cuda)
    table = (0.005 + 2e-4 * be.float()[:, None] + 2.4e-7 * se.float()[None, :]).contiguous()
    for s_min in (0.02, 0.06, -1.0):
        args = (seq, act, torch.tensor([s_min], device=cuda), table, be, se)
        sel, count = slack_pack(*args)
        sel_r, count_r = slack_pack_ref(*args)
        assert torch.equal(sel, sel_r) and torch.equal(count, count_r)
    assert (fcfs_scan.launches, slack_pack.launches) == (n0[0] + 1, n0[1] + 3)
    with pytest.raises(ValueError, match="float32"):
        fcfs_scan(a.double(), d, t0)
    with pytest.raises(ValueError, match="beyond"):
        slack_pack(seq, act, t0, torch.zeros(300, 2, device=cuda), be, se)


@pytest.mark.parametrize("kv_valid", [None, [4096, 17, 1, 300]])
def test_one_query_non_causal_attention_takes_the_decode_kernel(cuda, kv_valid):
    """The encoder-decoder's cross attention of a decode step (Sq == 1,
    non-causal) on the decode kernel, kv_len = kv_valid or the cache length,
    against the plain version in f32."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import attention

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(4, 1, 16, 64, generator=gen, device=cuda)
    k = torch.randn(4, 4096, 16, 64, generator=gen, device=cuda)
    v = torch.randn(4, 4096, 16, 64, generator=gen, device=cuda)
    kvl = None if kv_valid is None else torch.tensor(kv_valid, dtype=torch.int32, device=cuda)
    n0 = decode_attention.launches
    out = attention(q, k, v, torch.zeros(4, 1, dtype=torch.int32, device=cuda), kvl,
                    causal=False)
    assert decode_attention.launches == n0 + 1
    lens = kvl if kvl is not None else torch.full((4,), 4096, dtype=torch.int32, device=cuda)
    torch.testing.assert_close(out[:, 0], decode_attention_ref(q[:, 0], k, v, lens),
                               rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_backward_kernels_match_the_plain_backward(cuda, dtype):
    """Autograd through prefill_attention on the card (the forward kernel
    writing lse, the backward kernels) against the plain backward: f32
    within 2e-5 x max(1, max|ref|), bf16 within 1e-2 in relative norm of the
    plain backward in f32; GQA 4:1, q_pos offsets, ragged kv_len, cap 50."""
    from repro_torch.kernels.prefill_attention.ops import prefill_attention_bwd
    from repro_torch.kernels.prefill_attention.ref import (
        prefill_attention_bwd_ref,
        prefill_attention_lse,
    )

    gen = torch.Generator(device=cuda).manual_seed(0)
    b, sq, skv, hq, hkv, dh = 2, 100, 300, 8, 2, 64
    for cap in (0.0, 50.0):
        sc = 3.0 if cap else 1.0
        q, k, v = ((torch.randn(shape, generator=gen, device=cuda) * s).to(dtype)
                   .requires_grad_()
                   for shape, s in (((b, sq, hq, dh), sc), ((b, skv, hkv, dh), sc),
                                    ((b, skv, hkv, dh), 1.0)))
        do = torch.randn((b, sq, hq, dh), generator=gen, device=cuda).to(dtype)
        offs = torch.tensor([200, 57], device=cuda, dtype=torch.int32)
        q_pos = (offs[:, None] + torch.arange(sq, device=cuda, dtype=torch.int32)).contiguous()
        kv_len = torch.tensor([300, 140], device=cuda, dtype=torch.int32)
        n0 = prefill_attention_bwd.launches
        out = prefill_attention(q, k, v, q_pos, kv_len, logit_cap=cap)
        got = torch.autograd.grad(out, (q, k, v), do)
        assert prefill_attention_bwd.launches == n0 + 1
        with torch.no_grad():
            lse = prefill_attention_lse(q, k, q_pos, kv_len, logit_cap=cap)
            f = [t.float() for t in (q, k, v, out, do)]
            ref = prefill_attention_bwd_ref(*f[:4], lse, f[4], q_pos, kv_len, logit_cap=cap)
        for g, r in zip(got, ref, strict=True):
            if dtype == torch.float32:
                assert float((g - r).abs().max()) <= 2e-5 * max(1.0, float(r.abs().max()))
            else:
                assert float((g.float() - r).norm() / r.norm()) <= 1e-2


def test_wrappers_refuse_a_cuda_tensor_that_requires_grad(cuda):
    """No kernel wrapper returns a tensor without grad_fn for an input that
    requires grad: decode attention and the scheduler scans carry no
    gradient (the SSD scan's, through SSDScanFn, is the next test)."""
    from repro_torch.kernels.sched_scan.ops import fcfs_scan

    q = torch.zeros(1, 4, 32, device=cuda, requires_grad=True)
    k = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention: q requires grad"):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device=cuda))
    a = torch.zeros(4, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="fcfs_scan: a_s requires grad"):
        fcfs_scan(a, torch.zeros(4, device=cuda), torch.zeros(1, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_on_the_card_matches_the_plain_backward(cuda, dtype):
    """A small SSD gradient through `ssd` under grad (SSDScanFn, the forward
    writing S_in and the backward kernels, ssd_scan_bwd.cu) against
    `ssd_chunked_bwd` on the same inputs in f32 from the exact states: f32
    within 1e-4 x max(1, max|ref|), bf16 within SSD_BWD_BF16_REL in relative
    norm; a ragged L, an initial state, a loss on the final state."""
    from repro_torch.kernels.ssd_scan.ops import SSD_BWD_BF16_REL, ssd_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

    gen = torch.Generator(device=cuda).manual_seed(0)
    b, l, h, p, n, chunk = 2, 300, 4, 64, 64, 128

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    leaves = [rnd(b, l, h, p, scale=0.5).to(dtype),
              torch.rand((b, l, h), generator=gen, device=cuda) * 0.099 + 0.001,
              -(torch.rand((h,), generator=gen, device=cuda) * 3.5 + 0.5),
              rnd(b, l, n, scale=0.3).to(dtype), rnd(b, l, n, scale=0.3).to(dtype),
              rnd(b, h, p, n)]
    leaves = [t.requires_grad_() for t in leaves]
    dy, dfinal = rnd(b, l, h, p).to(dtype), rnd(b, h, p, n)
    n0 = ssd_bwd.launches
    y, fs = ssd(*leaves[:5], chunk=chunk, init_state=leaves[5])
    got = torch.autograd.grad([y, fs], leaves, [dy, dfinal])
    assert ssd_bwd.launches == n0 + 1
    with torch.no_grad():
        f = [t.detach().float() for t in leaves]
        ref = ssd_chunked_bwd(*f[:5], chunk, f[5], None, dy.float(), dfinal)
    for g, r in zip(got, ref, strict=True):
        if dtype == torch.float32:
            assert float((g - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))
        else:
            assert float((g.float() - r).norm() / r.norm()) <= SSD_BWD_BF16_REL


@pytest.mark.parametrize("shape", [(2, 200, 3, 32, 128, 64), (1, 300, 20, 64, 64, 128)])
def test_ssd_backward_routes_on_the_card(cuda, shape):
    """At a shape the tensor-core route takes (Q = 64 with P = 32, N = 128 and
    a ragged L; Q = 128 with a partial head group), bf16: `ssd_bwd` runs
    the tensor-core kernels by default and the scalar kernels when asked,
    counted per route; both within SSD_BWD_BF16_REL of the f32 plain
    backward from the exact states, the tensor-core one also within it of
    `ssd_tensor_core_bwd_emulation`, and two calls bit-identical."""
    from repro_torch.kernels.ssd_scan.ops import (SCALAR, SSD_BWD_BF16_REL, TENSOR_CORE,
                                                  ssd_bwd, ssd_fwd)
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd, ssd_tensor_core_bwd_emulation

    b, l, h, p, n, chunk = shape
    gen = torch.Generator(device=cuda).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    bf = torch.bfloat16
    x, Bm, Cm, dy = (rnd(b, l, h, p, scale=0.5).to(bf), rnd(b, l, n, scale=0.3).to(bf),
                     rnd(b, l, n, scale=0.3).to(bf), rnd(b, l, h, p).to(bf))
    dt = torch.rand((b, l, h), generator=gen, device=cuda) * 0.099 + 0.001
    A = -(torch.rand((h,), generator=gen, device=cuda) * 3.5 + 0.5)
    s0, dfinal = rnd(b, h, p, n), rnd(b, h, p, n)
    _, _, s_in = ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    before = dict(ssd_bwd.route_launches)
    tc = ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, dfinal, chunk=chunk, init_state=s0)
    again = ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, dfinal, chunk=chunk, init_state=s0)
    scalar = ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, dfinal, chunk=chunk, init_state=s0,
                     kernel=SCALAR)
    assert ssd_bwd.route_launches[TENSOR_CORE] == before[TENSOR_CORE] + 2
    assert ssd_bwd.route_launches[SCALAR] == before[SCALAR] + 1
    assert all(torch.equal(u, v) for u, v in zip(tc, again, strict=True))
    ref = ssd_chunked_bwd(x.float(), dt, A, Bm.float(), Cm.float(), chunk, s0, None, dy.float(),
                          dfinal)
    emu = ssd_tensor_core_bwd_emulation(x, dt, A, Bm, Cm, chunk, s0, s_in, dy, dfinal)
    for t, sc, e, r in zip(tc, scalar, emu, ref, strict=True):
        assert float((t.float() - r).norm() / r.norm()) <= SSD_BWD_BF16_REL
        assert float((sc.float() - r).norm() / r.norm()) <= SSD_BWD_BF16_REL
        assert float((t.float() - e.float()).norm() / r.norm()) <= SSD_BWD_BF16_REL


def test_a_small_train_step_on_the_card_matches_the_cpu(cuda):
    """llama3-8b-smoke in f32: loss and grads of a step at 2 microbatches on
    the card (prefill kernels and their backward) against the CPU."""
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.train_step import loss_and_grad_accum

    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    batch = SyntheticDataset(cfg, DataConfig(seq_len=64, global_batch=4)).batch_at(0)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    def flat(tree, p=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, p + k + "/") if isinstance(v, dict) else {p + k: v})
        return out

    lc, gc = loss_and_grad_accum(model, cpu, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 2)
    lg, gg = loss_and_grad_accum(model, to(cpu, cuda),
                                 {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}, 2)
    assert abs(float(lc) - float(lg)) <= 2e-5
    fg = flat(gg)
    for name, g in flat(gc).items():
        assert float((fg[name].cpu() - g).norm()) <= 1e-4 * max(float(g.norm()), 1e-6), name
