#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch/CUDA port builds, is right and
serves: the quickest check that ``repro_torch`` still starts on the card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  device   the card's name and power limit (nvidia-smi); TF32 off for
           float32 matmuls and convolutions, so f32 means f32
  build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
  kernels  every kernel against its plain PyTorch version on the card, over
           the sweep of tests/test_kernels.py and at the serving shapes of
           llama3-8b (attention), zamba2-2.7b (attention at Dh=80, SSD scan)
           and mamba2-130m (SSD scan), each in f32 (attention tol 2e-5, SSD
           1e-4) and bf16 (tol 2e-2; bf16 prefill also within 6e-3 in
           relative norm of the plain version in f32, logit cap included),
           with bf16 times (per call as its caller sees it, each run after
           an L2 flush, and the device time alone beside it), bounds and,
           for attention, a library call as yardstick; any mismatch
           beyond tolerance fails the run. The attention edges are
           checked bit for bit: NaN in the cache past kv_len changes no
           output (both kernels, both dtypes), and a sequence decoded alone equals it
           inside a batch of 8; decode at kv_len 1, at split boundaries
           and over several splits is held to the tolerance. This is the
           one on-card check of the kernels against their plain versions.
           The SSD scan runs two routes, printed per case: bf16 at its
           shapes on tensor cores (ssd_state_pass + ssd_chunk_out), also
           held within TC_REL_LIMIT (6e-3) in relative norm of the plain
           version in f32, y and final state, over every Q x P x N of the
           route at ragged L, L < Q, an initial state and a partial head
           group; everything else (f32, other shapes) on the scalar kernel.
           At the serving shapes two faults read off the plain version (the
           diagonal dropped, one chunk's S_in not carried) must exceed twice
           the limit, and bf16 is timed on both routes at B=2 and at the ssm
           phase's B=4
  serve    llama3-8b at full width and depth in bf16 (random weights from a
           seed) serves 8 requests through ServeSession under the Kairos
           policies, slot then paged KV; both attention kernels must launch
  fleet    the session stack above the engine, llama3-8b at full width and
           depth in bf16 (random weights from a seed, one copy shared by
           every server, real clocks): 16 requests of 64-1536 tokens (half
           opening with one 512-token head), 32 output tokens each, 50 ms
           apart, replayed by 4 clients through the async frontend, a
           prefix-affinity router over 2 paged replicas, a 1P:1D disagg
           fleet and a fleet controller (2 replicas, replica 0 killed 1 s
           in, queue-threshold autoscaling up to 3 through a server
           factory). Each: every request done with 32 tokens, the client's
           streams equal to the outputs, first token at the TTFT stamp, both
           attention kernels launched, every logit row finite; the router
           assigns both replicas and hits the shared prefix, the disagg
           fleet completes 16 handoffs with decode never before transfer
           ready, the controller records the kill and its recovery plan and
           restores requests on the survivors. TTFT and TPOT per request,
           walls and peak memory (before and after the kill) are printed
  eval     the evaluation harness at llama3-8b full width and depth in bf16
           (random weights from a seed, one bundle shared by every cell):
           run_grid over paper-longtail x kairos-urgency x kairos-slack x all
           six backends (sim, engine, async-engine, a 2-replica router, a
           1P:1D disagg fleet, a churn fleet that loses replica 0 at
           EVAL_KILL_AT with queue-threshold autoscaling up to 3) on the
           harness's ManualClocks, 24 requests of up to 1536 prompt and 32
           output tokens. Each cell: every request done, 0 sheds, the CPU
           test's schema, both attention kernels launched in every engine
           cell (counted from zero per cell), every logit row finite; the
           disagg cell completes 24 handoffs, the churn cell records the
           kill and its recovery plan. Then run_loadgen --realtime on one
           server, the same 24 requests at the trace's 3 qps in real
           seconds (SLOs TTFT 2.0 s, TPOT 0.1 s, placeholders), under
           kairos-urgency/kairos-slack and fcfs/continuous: TTFT, TPOT and
           E2E attainment, goodput, decode tokens/s, wall, TTFT and TPOT
           median and max are printed (no policy is asserted to win); fails
           only if a request is not terminal or a kernel did not launch
  parity   float32 at full width: llama3-8b cut to 4 layers, engine tokens
           under two policy pairs, slot and paged, equal reference_generate's,
           and so do those of the async frontend, a 2-replica router, a
           1P:1D and a 2P:1D disagg fleet and a fleet controller that kills
           a replica mid-run (on ManualClocks, so the kill catches the same
           requests on every card; they re-prefill on the survivor);
           mamba2-130m (full depth) and zamba2-2.7b (cut to 12 layers),
           Model.prefill's last logits equal token-by-token Model.decode's
           (tol 2e-4) and the 8 greedy tokens after both paths are equal
  ssm      zamba2-2.7b, then mamba2-130m, at full width and depth in bf16
           (random weights from a seed): Model.prefill of 4 right-padded
           prompts, handoff into a decode cache, 32 greedy Model.decode
           steps; the SSD scan (and for zamba2 both attention kernels) must
           launch once per layer, every SSD call on the tensor-core route;
           the SSD scan's share of the prefill (layers x its B=4 time)

Every phase runs on every call. It imports nothing of JAX or of the JAX
package, exits non-zero when there is no card or when run outside the
repository, and prints the kernel table and the card line before the last
line, which is the ``{"ok": true, ...}`` record. The table's launches are
the slot serve's (attention) and the zamba2 prefill's (SSD scan, whose row
is timed at that prefill's shape, B=4 L=2048), each counted from zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense, same sheet
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}  # atol = rtol, as tests/test_kernels.py
# bf16 prefill, relative to the f32 plain version (`_prefill_ref_f32`), beside
# the 2e-2 elementwise tolerance: the 2e-2 is some two thirds of a typical
# output at the serving shapes, so a dropped tile or a causal edge one row off
# would pass it. This limit is about twice the largest reading on an H100
# (2.8e-3 over the sweep and the serving shapes) and fails both: the kernels
# phase checks that a causal edge one row off moves the output by more than
# twice it at each serving shape (2.4e-2 at the llama3-8b chunk).
BF16_PREFILL_REL = 6e-3
SLEEP_CYCLES = 2_000_000  # ~1 ms of device spin at the H100's clock (`_time_ms`)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------- device
def phase_device(ctx) -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ctx["card"] = smi
    ctx["device"] = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count={torch.cuda.device_count()}")
    say("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")


# ---------------------------------------------------------------------- build
def phase_build(ctx) -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    wall = time.perf_counter() - t0
    say(f"[build] {len(built)} kernels in {wall:.1f} s wall "
        + " ".join(f"{k}={v[0]:.1f}s" for k, v in built.items()))
    for name, (_, log) in built.items():
        for line in log.splitlines():
            low = line.lower()
            if any(k in low for k in ("registers", "spill", "serializ", "error")):
                say(f"[build] {name}: {line.strip()}")


# -------------------------------------------------------------------- kernels
def _time_ms(fn, *, iters: int, flush, device_only: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` runs, each after an L2 flush (the
    serving path finds each layer's K/V cold), between two CUDA events: the
    time per call as its caller sees it, which is the device's time or,
    where the host takes longer to issue the call than the flush takes to
    run, the host's. The kernel table's ``ms``, ``plain_ms`` and
    ``library_ms`` are this. With ``device_only`` the device first spins
    ~1 ms, so the host has queued all of ``fn`` before the first event and
    the events bracket device time alone (``device_ms``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def _rel_err(out, ref) -> float:
    """||out - ref|| / ||ref||, over the whole tensor."""
    return float((out.float() - ref.float()).norm() / ref.float().norm())


def _prefill_ref_f32(q, k, v, q_pos, kv_len, logit_cap=0.0):
    """The plain version of prefill attention computed in f32 from the same
    (bf16) inputs, with P rounded to bf16 before P.V as the kernel and the
    reference round it, and the output left in f32: what the bf16 kernel is
    held to in relative norm (`BF16_PREFILL_REL`)."""
    import torch

    from repro_torch.kernels.prefill_attention.ref import NEG_INF

    rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / q.shape[-1] ** 0.5
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    kvp = torch.arange(k.shape[1], device=q.device)
    mask = (kvp[None, None, :] <= q_pos[:, :, None]) & (kvp[None, None, :] < kv_len[:, None, None])
    p = torch.softmax(torch.where(mask[:, None], s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)


def _check_bf16_prefill(out, q, k, v, q_pos, kv_len, what, logit_cap=0.0) -> float:
    """The bf16 prefill kernel's output against `_prefill_ref_f32` in
    relative norm; returns the reading."""
    rel = _rel_err(out, _prefill_ref_f32(q, k, v, q_pos, kv_len, logit_cap))
    check(rel <= BF16_PREFILL_REL, f"prefill_attention bf16 {what}: relative error {rel:.3e} "
          f"beyond {BF16_PREFILL_REL}")
    return rel


def _max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def _close(out, ref, dtype) -> bool:
    import torch

    tol = TOL[str(dtype)]
    return bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))


def _randn(gen, shape, dtype, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def phase_kernels(ctx) -> None:
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    sweep_err = {"prefill_attention": 0.0, "decode_attention": 0.0}
    sweep_rel = 0.0  # bf16 prefill, relative to the f32 plain version

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    # the sweep of tests/test_kernels.py, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, hq, hkv, dh in [
            (2, 128, 256, 4, 2, 64), (1, 64, 64, 8, 8, 128), (2, 100, 300, 6, 2, 32),
            (1, 256, 512, 4, 1, 128), (3, 32, 160, 4, 2, 16), (2, 96, 96, 4, 4, 80),
        ]:
            q = _randn(gen, (b, sq, hq, dh), dtype)
            k = _randn(gen, (b, skv, hkv, dh), dtype)
            v = _randn(gen, (b, skv, hkv, dh), dtype)
            offs = ints(0, skv - sq + 1, b)
            q_pos = (offs[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)).contiguous()
            kv_len = (offs + sq).to(torch.int32)
            out = prefill_attention(q, k, v, q_pos, kv_len)
            ref = prefill_attention_ref(q, k, v, q_pos, kv_len)
            err = _max_err(out, ref)
            sweep_err["prefill_attention"] = max(sweep_err["prefill_attention"], err)
            check(_close(out, ref, dtype),
                  f"prefill_attention {dtype} {(b, sq, skv, hq, hkv, dh)}: max err {err}")
            if dtype == torch.bfloat16:
                sweep_rel = max(sweep_rel, _check_bf16_prefill(
                    out, q, k, v, q_pos, kv_len, str((b, sq, skv, hq, hkv, dh))))
        for b, s, hq, hkv, dh in [
            (4, 512, 8, 2, 64), (2, 300, 4, 4, 128), (1, 1024, 16, 2, 32), (3, 96, 8, 1, 128),
        ]:
            q = _randn(gen, (b, hq, dh), dtype)
            k = _randn(gen, (b, s, hkv, dh), dtype)
            v = _randn(gen, (b, s, hkv, dh), dtype)
            kv_len = ints(1, s + 1, b)
            out = decode_attention(q, k, v, kv_len)
            ref = decode_attention_ref(q, k, v, kv_len)
            err = _max_err(out, ref)
            sweep_err["decode_attention"] = max(sweep_err["decode_attention"], err)
            check(_close(out, ref, dtype),
                  f"decode_attention {dtype} {(b, s, hq, hkv, dh)}: max err {err}")
    # logit cap 30 (f32, inputs scaled by 3 so the cap bites)
    q = _randn(gen, (1, 64, 4, 32), torch.float32, 3.0)
    k = _randn(gen, (1, 128, 2, 32), torch.float32, 3.0)
    v = _randn(gen, (1, 128, 2, 32), torch.float32)
    q_pos = (torch.arange(64, device=dev, dtype=torch.int32) + 64)[None].contiguous()
    kv_len = torch.tensor([128], device=dev, dtype=torch.int32)
    out = prefill_attention(q, k, v, q_pos, kv_len, logit_cap=30.0)
    ref = prefill_attention_ref(q, k, v, q_pos, kv_len, logit_cap=30.0)
    check(_close(out, ref, torch.float32), f"prefill logit cap: max err {_max_err(out, ref)}")
    qd = _randn(gen, (2, 4, 32), torch.float32, 3.0)
    out = decode_attention(qd, k.expand(2, -1, -1, -1).contiguous(),
                           v.expand(2, -1, -1, -1).contiguous(),
                           torch.tensor([128, 77], device=dev, dtype=torch.int32), logit_cap=30.0)
    ref = decode_attention_ref(qd, k.expand(2, -1, -1, -1), v.expand(2, -1, -1, -1),
                               torch.tensor([128, 77], device=dev, dtype=torch.int32),
                               logit_cap=30.0)
    check(_close(out, ref, torch.float32), f"decode logit cap: max err {_max_err(out, ref)}")
    # logit cap 30 in bf16, on the wgmma kernel, at llama3-8b's chunk shape
    q = _randn(gen, (1, 512, 32, 128), torch.bfloat16, 3.0)
    k = _randn(gen, (1, 2048, 8, 128), torch.bfloat16, 3.0)
    v = _randn(gen, (1, 2048, 8, 128), torch.bfloat16)
    q_pos = (torch.arange(512, device=dev, dtype=torch.int32) + 1536)[None].contiguous()
    kv_len = torch.tensor([2048], device=dev, dtype=torch.int32)
    out = prefill_attention(q, k, v, q_pos, kv_len, logit_cap=30.0)
    ref = prefill_attention_ref(q, k, v, q_pos, kv_len, logit_cap=30.0)
    check(_close(out, ref, torch.bfloat16), f"prefill logit cap bf16: max err {_max_err(out, ref)}")
    cap_rel = _check_bf16_prefill(out, q, k, v, q_pos, kv_len, "logit cap 30", logit_cap=30.0)
    # stale tail: entries past kv_len leave the output bit-identical
    q = _randn(gen, (2, 4, 32), torch.float32)
    k = _randn(gen, (2, 256, 2, 32), torch.float32)
    v = _randn(gen, (2, 256, 2, 32), torch.float32)
    kv_len = torch.tensor([100, 17], device=dev, dtype=torch.int32)
    out1 = decode_attention(q, k, v, kv_len)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 1e4
    v2[:, 200:] = -1e4
    out2 = decode_attention(q, k2, v2, kv_len)
    check(torch.equal(out1, out2), "decode_attention: stale cache tail changed the output")
    say(f"[kernels] sweep ok (f32 tol 2e-5, bf16 tol 2e-2, every Dh of HEAD_DIMS, logit cap 30, "
        f"stale tail bit-identical); max abs err prefill {sweep_err['prefill_attention']:.3e} "
        f"decode {sweep_err['decode_attention']:.3e}; bf16 prefill relative error (limit "
        f"{BF16_PREFILL_REL}) sweep max {sweep_rel:.3e}, logit cap 30 at the llama3-8b chunk "
        f"{cap_rel:.3e}")
    _attention_edge_checks(gen)

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB of L2

    def flush():
        flush_buf.zero_()

    # the serving shapes of llama3-8b (the kernel table's rows): a 512-token
    # prefill chunk at offset 1536 over a 2048-row prefix, and a decode batch
    # of 8 over 2048-row caches with mixed kv_len
    rows = [
        _prefill_row(gen, flush, 1, 512, 2048, 32, 8, 128),
        _decode_row(gen, flush, 8, 2048, 32, 8, 128, [2048, 1900, 1536, 1024, 700, 512, 130, 64]),
    ]
    # zamba2-2.7b's shared attention (MHA 32/32, Dh=80): its 2048-token
    # prefill, and decode of its 4 requests over a 2080-row cache
    extra = [
        _prefill_row(gen, flush, 1, 2048, 2048, 32, 32, 80),
        _decode_row(gen, flush, 4, 2080, 32, 32, 80, [2080, 1568, 732, 162]),
    ]
    for r in rows + extra:
        rel = (f", relative error bf16 {r.pop('rel_err'):.3e} (limit {BF16_PREFILL_REL}; "
               f"causal edge one row off: {r.pop('edge_rel'):.3e})" if "rel_err" in r else "")
        say(f"[kernels] {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms per call (device "
            f"alone {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms (device alone {r['library_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err bf16 {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}), f32 {r['max_abs_err_f32']:.3e} (tol {TOL['torch.float32']})"
            f"{rel} [{ctx['card']}]")
    rows.append(_ssd_checks(ctx, gen, flush))
    ctx["kernel_rows"] = rows


def _attention_edge_checks(gen) -> None:
    """The edges of the redesigned kernels: NaN in the cache past kv_len
    (both kernels, f32 and bf16, kv_len ending inside a tile) leaves the
    output bit-identical to a clean tail; decode at kv_len 1, at a split
    boundary and over several splits within tolerance; and one sequence
    decoded alone equals, bit for bit, the same sequence inside a batch of
    8, and inside a cache cut to its own kv_len."""
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import SPLIT_ROWS, decode_attention_ref
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    dev = torch.device("cuda")

    def nan_tail(t, lens):
        t = t.clone()
        for i, n in enumerate(lens):
            t[i, n:] = float("nan")
        return t

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        # prefill: chunks whose kv_len ends inside a 64-row tile
        b, sq, skv, hq, hkv, dh = 2, 100, 300, 8, 2, 128
        q = _randn(gen, (b, sq, hq, dh), dtype)
        k = _randn(gen, (b, skv, hkv, dh), dtype)
        v = _randn(gen, (b, skv, hkv, dh), dtype)
        lens = [237, 150]
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        q_pos = (kv_len[:, None] - sq + torch.arange(sq, device=dev, dtype=torch.int32)).contiguous()
        out1 = prefill_attention(q, k, v, q_pos, kv_len)
        out2 = prefill_attention(q, nan_tail(k, lens), nan_tail(v, lens), q_pos, kv_len)
        check(torch.equal(out1, out2), f"prefill_attention {dtype}: NaN past kv_len changed the output")
        if dtype == torch.bfloat16:
            _check_bf16_prefill(out1, q, k, v, q_pos, kv_len, f"kv_len {lens}")
        # decode: kv_len 1, at split boundaries, over several splits, and NaN past it
        b, s, hq, hkv, dh = 8, 4 * SPLIT_ROWS + 40, 32, 8, 128
        lens = [1, SPLIT_ROWS, SPLIT_ROWS + 1, 2 * SPLIT_ROWS, 3 * SPLIT_ROWS - 1, 77, 4 * SPLIT_ROWS + 40,
                4 * SPLIT_ROWS + 3]
        kv_len = torch.tensor(lens, device=dev, dtype=torch.int32)
        q = _randn(gen, (b, hq, dh), dtype)
        k = _randn(gen, (b, s, hkv, dh), dtype)
        v = _randn(gen, (b, s, hkv, dh), dtype)
        out = decode_attention(q, k, v, kv_len)
        ref = decode_attention_ref(q, k, v, kv_len)
        worst = max(worst, _max_err(out, ref)) if dtype == torch.bfloat16 else worst
        check(_close(out, ref, dtype), f"decode_attention {dtype} kv_len {lens}: max err "
              f"{_max_err(out, ref)}")
        out2 = decode_attention(q, nan_tail(k, lens), nan_tail(v, lens), kv_len)
        check(torch.equal(out, out2), f"decode_attention {dtype}: NaN past kv_len changed the output")
        for i in (0, 4, 6):  # batch invariance, and independence of S
            alone = decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_len[i:i + 1])
            cut = decode_attention(q[i:i + 1], k[i:i + 1, :lens[i]].contiguous(),
                                   v[i:i + 1, :lens[i]].contiguous(), kv_len[i:i + 1])
            check(torch.equal(alone, out[i:i + 1]) and torch.equal(cut, out[i:i + 1]),
                  f"decode_attention {dtype}: sequence {i} alone differs from it in the batch")
    say(f"[kernels] edges ok: NaN past kv_len bit-identical (prefill f32/bf16, kv_len inside a "
        f"tile; decode f32/bf16); decode at kv_len 1, split boundaries ({SPLIT_ROWS}-row "
        f"splits) and 5 splits within tolerance (bf16 max abs err {worst:.3e}); a sequence alone, "
        f"in a batch of 8 and in a cache cut to its kv_len bit-identical")


def _prefill_row(gen, flush, b, sq, skv, hq, hkv, dh) -> dict:
    """prefill_attention against its plain version at one serving shape, the
    chunk at the end of the prefix: checked in f32 (the tight tolerance) then
    bf16 (the serving dtype, which is timed, with SDPA as yardstick)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

    dev = torch.device("cuda")
    q_pos = (torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq))[None].expand(b, sq)
    q_pos = q_pos.contiguous()
    kv_len = torch.full((b,), skv, device=dev, dtype=torch.int32)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(gen, (b, sq, hq, dh), dtype)
        k = _randn(gen, (b, skv, hkv, dh), dtype)
        v = _randn(gen, (b, skv, hkv, dh), dtype)
        out = prefill_attention(q, k, v, q_pos, kv_len)
        ref = prefill_attention_ref(q, k, v, q_pos, kv_len)
        errs[dtype] = _max_err(out, ref)
        check(_close(out, ref, dtype),
              f"prefill_attention at serving shape Dh={dh} {dtype}: max err {errs[dtype]}")
    rel = _check_bf16_prefill(out, q, k, v, q_pos, kv_len, f"at serving shape Dh={dh}")
    # what the limit must catch: the plain version with its causal edge one row off
    edge_rel = _rel_err(_prefill_ref_f32(q, k, v, q_pos + 1, kv_len),
                        _prefill_ref_f32(q, k, v, q_pos, kv_len))
    check(edge_rel > 2 * BF16_PREFILL_REL, f"prefill_attention Dh={dh}: a causal edge one row "
          f"off moves the output by {edge_rel:.3e}, not clearly beyond {BF16_PREFILL_REL}")
    kvp = torch.arange(skv, device=dev)
    mask = ((kvp[None, None, :] <= q_pos[:, :, None])
            & (kvp[None, None, :] < kv_len[:, None, None]))[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda device_only: _time_ms(  # noqa: E731
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True),
        iters=20, flush=flush, device_only=device_only)
    visible = torch.minimum(q_pos.long() + 1, kv_len.long()[:, None]).sum().item()
    kv_rows = min(skv, int(q_pos.max()) + 1)
    flops = 4 * hq * dh * visible
    nbytes = 2 * (2 * b * sq * hq * dh + 2 * b * kv_rows * hkv * dh) + 4 * (b * sq + b)
    return dict(
        name="prefill_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/prefill_attention.cu",
        replaces="src/repro/kernels/prefill_attention/kernel.py:83",
        max_abs_err=errs[torch.bfloat16], tol=TOL["torch.bfloat16"],
        max_abs_err_f32=errs[torch.float32],
        rel_err=rel, edge_rel=edge_rel,
        ms=_time_ms(lambda: prefill_attention(q, k, v, q_pos, kv_len), iters=20, flush=flush),
        device_ms=_time_ms(lambda: prefill_attention(q, k, v, q_pos, kv_len), iters=20,
                           flush=flush, device_only=True),
        plain_ms=_time_ms(lambda: prefill_attention_ref(q, k, v, q_pos, kv_len), iters=5,
                          flush=flush),
        library_ms=lib(False), library_device_ms=lib(True),
        **_bound(flops, nbytes, "torch.bfloat16"),
        shape=f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} bf16, q_pos {skv - sq}..{skv - 1}",
    )


def _decode_row(gen, flush, b, s, hq, hkv, dh, kv_lens) -> dict:
    """decode_attention against its plain version at one serving shape, f32
    then bf16 (timed, with SDPA as yardstick)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    kv_len = torch.tensor(kv_lens, device=dev, dtype=torch.int32)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(gen, (b, hq, dh), dtype)
        k = _randn(gen, (b, s, hkv, dh), dtype)
        v = _randn(gen, (b, s, hkv, dh), dtype)
        out = decode_attention(q, k, v, kv_len)
        ref = decode_attention_ref(q, k, v, kv_len)
        errs[dtype] = _max_err(out, ref)
        check(_close(out, ref, dtype),
              f"decode_attention at serving shape Dh={dh} {dtype}: max err {errs[dtype]}")
    dmask = (torch.arange(s, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    qt4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda device_only: _time_ms(  # noqa: E731
        lambda: F.scaled_dot_product_attention(qt4, kt, vt, attn_mask=dmask, enable_gqa=True),
        iters=50, flush=flush, device_only=device_only)
    tot = int(kv_len.sum())
    flops = 4 * hq * dh * tot
    nbytes = 2 * (2 * tot * hkv * dh + 2 * b * hq * dh) + 4 * b
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:77",
        max_abs_err=errs[torch.bfloat16], tol=TOL["torch.bfloat16"],
        max_abs_err_f32=errs[torch.float32],
        ms=_time_ms(lambda: decode_attention(q, k, v, kv_len), iters=50, flush=flush),
        device_ms=_time_ms(lambda: decode_attention(q, k, v, kv_len), iters=50, flush=flush,
                           device_only=True),
        plain_ms=_time_ms(lambda: decode_attention_ref(q, k, v, kv_len), iters=10,
                          flush=flush),
        library_ms=lib(False), library_device_ms=lib(True),
        **_bound(flops, nbytes, "torch.bfloat16"),
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} bf16, kv_len {kv_len.tolist()}",
    )


def _ssd_inputs(gen, b, l, h, p, n, dtype):
    import torch

    dev = torch.device("cuda")
    x = _randn(gen, (b, l, h, p), dtype, 0.5)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 0.001
    A = -(torch.rand((h,), generator=gen, device=dev) * 3.5 + 0.5)
    Bm = _randn(gen, (b, l, n), dtype, 0.3)
    Cm = _randn(gen, (b, l, n), dtype, 0.3)
    return x, dt, A, Bm, Cm


def _ssd_ref_f32(x, dt, A, Bm, Cm, chunk, s0=None):
    """The plain version of the SSD scan computed in f32 from the same (bf16)
    inputs, y left in f32: what the tensor-core route is held to in relative
    norm (`TC_REL_LIMIT`)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    return ssd_chunked(x.float(), dt, A, Bm.float()[:, :, None], Cm.float()[:, :, None],
                       min(chunk, x.shape[1]), s0)


def _ssd_controls(x, dt, A, Bm, Cm, chunk, y32) -> dict:
    """What the relative-norm limit must catch, from the plain version alone:
    y with the diagonal of the decayed scores dropped (the causal mask one
    column off, j < i), and y whose middle chunk starts from a zero state
    (that chunk's S_in not carried). Returns each one's relative distance
    from the true y32."""
    diag = (Bm.float() * Cm.float()).sum(-1)[:, :, None, None] * dt[..., None] * x.float()
    c0 = (x.shape[1] // chunk // 2) * chunk  # the middle chunk's first row
    cut = slice(c0, c0 + chunk)
    y_cut, _ = _ssd_ref_f32(x[:, cut], dt[:, cut], A, Bm[:, cut], Cm[:, cut], chunk)
    dropped = y32.clone()
    dropped[:, cut] = y_cut
    return dict(diagonal=_rel_err(y32 - diag, y32), s_in=_rel_err(dropped, y32))


def _ssd_kernel_ms(ssd_args, kernel) -> dict:
    """Device time alone of each kernel the route launches, mean over 10
    calls under torch.profiler, by kernel name (ssd_state_pass,
    ssd_chunk_out, ssd_scan_kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan.ops import ssd

    x, dt, A, Bm, Cm = ssd_args
    ssd(x, dt, A, Bm, Cm, kernel=kernel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssd(x, dt, A, Bm, Cm, kernel=kernel)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("ssd_state_pass", "ssd_chunk_out", "ssd_scan_kernel"):
            if name in e.key and e.self_device_time_total > 0:
                out[name] = e.self_device_time_total / e.count / 1e3
    return out


def _ssd_checks(ctx, gen, flush) -> dict:
    """ssd_scan against its plain version over the sweep of
    tests/test_kernels.py, every shape class of the tensor-core route
    (Q in {64, 128} x P in {32, 64} x N in {32, 64, 128} at a ragged L,
    L < Q, an initial state, a head count that leaves a partial head group)
    and the serving shapes of zamba2-2.7b and mamba2-130m at B = 2 and at the
    ssm phase's B = 4, each in f32 (tol 1e-4, the JAX kernel test's; the
    scalar kernel) and bf16 (2e-2; on the tensor-core route also within
    `TC_REL_LIMIT` in relative norm of the plain version in f32, y and the
    final state). At the serving shapes two faults the limit must catch are
    read off the plain version, and bf16 is timed on both routes. Returns
    the kernel table's row, at the ssm phase's zamba2 shape (B = 4)."""
    import itertools

    import torch

    from repro_torch.kernels.ssd_scan.ops import SCALAR, TC_REL_LIMIT, TENSOR_CORE, route, ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    dev = torch.device("cuda")
    serving = {("zamba2-2.7b", 2): (2, 2048, 80, 64, 64, 128),
               ("mamba2-130m", 2): (2, 2048, 24, 64, 128, 128),
               ("zamba2-2.7b", 4): (4, 2048, 80, 64, 64, 128),
               ("mamba2-130m", 4): (4, 2048, 24, 64, 128, 128)}
    # (b, l, h, p, n, chunk, initial state)
    sweep = [(2, 256, 4, 64, 32, 64, False), (1, 100, 2, 32, 16, 32, False),
             (2, 128, 8, 16, 64, 128, False), (2, 300, 4, 64, 128, 128, True)]
    shapes = itertools.product((64, 128), (32, 64), (32, 64, 128))  # Q x P x N
    tc_cases = [(2 if n == 64 else 1, 300, 3, p, n, q, i % 2 == 0)
                for i, (q, p, n) in enumerate(shapes)]
    tc_cases += [(2, 50, 4, 32, 32, 64, True), (1, 100, 3, 64, 128, 128, False),  # L < Q
                 (4, 2048, 20, 64, 64, 128, True),  # 3 head groups of 8, the last of 4
                 (2, 2048, 24, 32, 128, 64, False)]  # groups of 8 heads at Q = 64
    cases = sweep + tc_cases + [(*v, False) for v in serving.values()]
    sweep_err, sweep_rel, routes, errs, rels, timed, controls = 0.0, 0.0, {}, {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, h, p, n, chunk, with_s0 in cases:
            shape = (b, l, h, p, n, chunk)
            x, dt, A, Bm, Cm = _ssd_inputs(gen, b, l, h, p, n, dtype)
            s0 = _randn(gen, (b, h, p, n), torch.float32) if with_s0 else None
            kernel = route(dtype, p, n, chunk)
            routes[kernel] = routes.get(kernel, 0) + 1
            y, fs = ssd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
            yr, fsr = ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], min(chunk, l), s0)
            err = max(_max_err(y, yr), _max_err(fs, fsr))
            t = tol[dtype]
            check(bool(torch.allclose(y.float(), yr.float(), rtol=t, atol=t)
                       and torch.allclose(fs, fsr, rtol=t, atol=t)),
                  f"ssd_scan {dtype} {shape} ({kernel}): max err {err}")
            rel = None
            if kernel == TENSOR_CORE:
                y32, fs32 = _ssd_ref_f32(x, dt, A, Bm, Cm, chunk, s0)
                rel = max(_rel_err(y, y32), _rel_err(fs, fs32))
                check(rel <= TC_REL_LIMIT, f"ssd_scan bf16 {shape} ({kernel}): relative error "
                      f"{rel:.3e} beyond {TC_REL_LIMIT}")
            if dtype == torch.bfloat16:
                say(f"[kernels] ssd_scan bf16 B={b} L={l} H={h} P={p} N={n} Q={chunk}"
                    f"{' init_state' if with_s0 else ''}: route {kernel}, max abs err {err:.3e}"
                    + (f", relative error {rel:.3e}" if rel is not None else ""))
            name = next((k for k, v in serving.items() if v == shape), None)
            if name is None:
                sweep_err = max(sweep_err, err)
                sweep_rel = max(sweep_rel, rel or 0.0)
                continue
            errs[(name, dtype)] = err
            if dtype == torch.float32:
                continue
            rels[name] = rel
            controls[name] = _ssd_controls(x, dt, A, Bm, Cm, chunk, y32)
            check(min(controls[name].values()) > 2 * TC_REL_LIMIT,
                  f"ssd_scan {name}: a fault the limit must catch reads {controls[name]}, not "
                  f"clearly beyond {TC_REL_LIMIT}")
            args = (x, dt, A, Bm, Cm)
            timed[name] = dict(
                ms=_time_ms(lambda: ssd(*args), iters=20, flush=flush),
                device_ms=_time_ms(lambda: ssd(*args), iters=20, flush=flush, device_only=True),
                scalar_ms=_time_ms(lambda: ssd(*args, kernel=SCALAR), iters=10, flush=flush),
                scalar_device_ms=_time_ms(lambda: ssd(*args, kernel=SCALAR), iters=10,
                                          flush=flush, device_only=True),
                plain_ms=_time_ms(lambda: ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None],
                                                      chunk), iters=5, flush=flush),
                kernels={**_ssd_kernel_ms(args, TENSOR_CORE), **_ssd_kernel_ms(args, SCALAR)},
                **_bound(*_ssd_work(b, l, h, p, n, chunk, 2), "torch.bfloat16"),
            )
    say(f"[kernels] ssd_scan sweep ok (f32 tol 1e-4, bf16 tol 2e-2 and, on the tensor-core "
        f"route, relative error within {TC_REL_LIMIT}; initial state, ragged L, L < Q, partial "
        f"head group); calls by route {routes}; max abs err {sweep_err:.3e}, max relative error "
        f"{sweep_rel:.3e}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (arch, bb), (b, l, h, p, n, chunk) in serving.items():
        r, k, c = timed[(arch, bb)], timed[(arch, bb)]["kernels"], controls[(arch, bb)]
        say(f"[kernels] ssd_scan at {arch} B={b} L={l} H={h} P={p} N={n} Q={chunk} bf16: "
            f"tensor-core route {r['ms']:.4f} ms per call (device alone {r['device_ms']:.4f} ms: "
            f"ssd_state_pass {k['ssd_state_pass']:.4f} + ssd_chunk_out {k['ssd_chunk_out']:.4f} "
            f"ms profiled), scalar kernel {r['scalar_ms']:.4f} ms (device alone "
            f"{r['scalar_device_ms']:.4f} ms; profiled {k['ssd_scan_kernel']:.4f} ms), "
            f"{r['scalar_device_ms'] / r['device_ms']:.1f}x; plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); max abs err bf16 "
            f"{errs[((arch, bb), torch.bfloat16)]:.3e} (tol 2e-2), relative error "
            f"{rels[(arch, bb)]:.3e} (limit {TC_REL_LIMIT}; diagonal dropped: "
            f"{c['diagonal']:.3e}, middle chunk's S_in not carried: {c['s_in']:.3e}), f32 "
            f"{errs[((arch, bb), torch.float32)]:.3e} (tol 1e-4); {b * h} scalar blocks on {sms} "
            f"SMs [{ctx['card']}]")
    ctx["ssd_device_ms"] = {arch: timed[(arch, 4)]["device_ms"] for arch, _ in serving}
    z = timed[("zamba2-2.7b", 4)]
    return dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:85",
        max_abs_err=errs[(("zamba2-2.7b", 4), torch.bfloat16)], tol=tol[torch.bfloat16],
        max_abs_err_f32=errs[(("zamba2-2.7b", 4), torch.float32)],
        rel_err=rels[("zamba2-2.7b", 4)],
        ms=z["ms"], device_ms=z["device_ms"], plain_ms=z["plain_ms"],
        scalar_ms=z["scalar_ms"], scalar_device_ms=z["scalar_device_ms"],
        library_ms=None,  # no one PyTorch call scans SSD
        bound_ms=z["bound_ms"], bound_by=z["bound_by"], shape="zamba2-2.7b B=4 L=2048 bf16",
    )


def _ssd_work(b, l, h, p, n, chunk, esize):
    """(operations, bytes) of one SSD scan: per (batch, head, chunk of q
    rows) 2 q^2 N (C B^T) + 2 q^2 P (scores . x dt) + 2 q N P (C state^T) +
    2 q P N (state increment); x and y, dt, B and C once, the final state."""
    q = min(chunk, l)
    rows = [q] * (l // q) + ([l % q] if l % q else [])
    flops = b * h * sum(2 * r * r * (n + p) + 4 * r * n * p for r in rows)
    nbytes = esize * (2 * b * l * h * p + 2 * b * l * n) + 4 * (b * l * h + h + b * h * p * n)
    return flops, nbytes


def _bound(flops: float, nbytes: float, dtype: str) -> dict:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------- serve
def _requests(prompts, max_out, gap, ttft, tpot):
    from repro_torch.core.request import Request, SLOSpec

    return [
        (Request(rid=i, arrival=gap * i, input_len=len(p), output_len=max_out,
                 slo=SLOSpec(ttft=ttft, tpot=tpot)), p)
        for i, p in enumerate(prompts)
    ]


class _Probe:
    """Times the prefill chunks and decode steps of every server it watches
    (both end in a device sync) and records, without syncing, whether every
    logit row the engine produced was finite."""

    def __init__(self, *servers):
        import torch

        from repro_torch.serving import engine

        self.chunk_s, self.step_s, self.finite = [], [], []
        self._engine, self._sample, self._chunk = engine, engine.sample, engine.chunk_prefill_step

        def sample(logits, **kw):
            self.finite.append(torch.isfinite(logits).all())
            return self._sample(logits, **kw)

        def chunk(*args, **kw):
            logits, cache = self._chunk(*args, **kw)
            self.finite.append(torch.isfinite(logits).all())
            return logits, cache

        engine.sample, engine.chunk_prefill_step = sample, chunk
        for server in servers:
            self.watch(server)

    def watch(self, server):
        for obj, name, sink in ((server.prefill, "run_chunk", self.chunk_s),
                                (server.decode, "step", self.step_s)):
            setattr(obj, name, self._timed(getattr(obj, name), sink))
        return server

    @staticmethod
    def _timed(fn, sink):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sink.append(time.perf_counter() - t0)
            return out
        return wrapped

    def close(self) -> bool:
        self._engine.sample, self._engine.chunk_prefill_step = self._sample, self._chunk
        return all(bool(f) for f in self.finite)


def _serve_once(model, params, ecfg, reqs, ctx, label):
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.serving.engine import DisaggServer
    from repro_torch.serving.session import ServeSession

    server = DisaggServer(model, params, ecfg, device=ctx["device"])
    probe = _Probe(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    session = ServeSession(server)
    outs = session.run(reqs)
    wall = time.perf_counter() - t0
    launches = {"prefill_attention": prefill_attention.launches,
                "decode_attention": decode_attention.launches}
    finite = probe.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    card = ctx["card"]
    for r, _ in reqs:
        check(r.phase.value == "done" and len(outs.get(r.rid, [])) == r.output_len,
              f"{label}: rid {r.rid} ended {r.phase.value} with "
              f"{len(outs.get(r.rid, []))}/{r.output_len} tokens")
        say(f"[serve] {label} rid={r.rid} prompt={r.input_len} out={len(outs[r.rid])} "
            f"ttft={r.ttft():.4f}s tpot={r.mean_tpot():.5f}s e2e_ok={r.meets_e2e()} [{card}]")
    check(finite, f"{label}: a logit row was not finite")
    check(all(n > 0 for n in launches.values()), f"{label}: a kernel never launched: {launches}")
    say(f"[serve] {label}: {len(reqs)} requests in {wall:.3f} s; prefill chunks "
        f"{len(probe.chunk_s)} mean {1e3 * sum(probe.chunk_s) / len(probe.chunk_s):.2f} ms; "
        f"decode steps {len(probe.step_s)} mean {1e3 * sum(probe.step_s) / len(probe.step_s):.2f} ms; "
        f"launches {launches}; peak memory {peak:.2f} GiB; all logits finite [{card}]")
    return outs, launches


def phase_serve(ctx) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.smoke_workload import smoke_engine_config, smoke_requests
    from repro_torch.models import build_model

    cfg = get_config("llama3-8b")  # full width and depth, bf16 (the config's own dtype)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=ctx["device"])
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.3f} B random parameters (seed 0) "
        f"in {time.perf_counter() - t0:.1f} s")
    slot_out, launches = _serve_once(model, params, smoke_engine_config(),
                                     smoke_requests(cfg.vocab_size), ctx, "slot")
    ctx["launches"] = launches  # the main path's run, counts zeroed just before it
    torch.cuda.empty_cache()
    paged_out, _ = _serve_once(model, params, smoke_engine_config(page_size=64),
                               smoke_requests(cfg.vocab_size), ctx, "paged")
    same = sum(paged_out[i] == slot_out[i] for i in slot_out)
    say(f"[serve] paged (page_size=64) tokens equal to slot tokens for {same}/{len(slot_out)} "
        "requests (bf16: argmax ties may flip between batch shapes; f32 parity is checked "
        "in the parity phase)")
    del params
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------- fleet
FLEET_KILL_AT = 1.0  # seconds into the FleetSession run: replica 0 dies


class _StreamLog:
    """Wraps a session's ``submit`` so that every handle's stream is logged
    as its client reads it: the tokens, and the server clock's reading at
    the first one."""

    def __init__(self, submit, now):
        self._submit, self._now = submit, now
        self.tokens, self.first_seen = {}, {}

    async def submit(self, request, prompt, at=None):
        return _LoggedHandle(await self._submit(request, prompt, at=at), self)

    def record(self, rid, tok) -> None:
        if rid not in self.tokens:
            self.first_seen[rid] = self._now()
        self.tokens.setdefault(rid, []).append(tok)


class _LoggedHandle:
    def __init__(self, handle, log: _StreamLog):
        self._handle, self._log, self.rid = handle, log, handle.rid

    async def stream(self):
        async for tok in self._handle.stream():
            self._log.record(self.rid, tok)
            yield tok


def _attention_launches(zero: bool = False) -> dict:
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention

    if zero:
        prefill_attention.launches = decode_attention.launches = 0
    return {"prefill_attention": prefill_attention.launches,
            "decode_attention": decode_attention.launches}


def _fleet_run(ctx, label, build, pairs, check_more) -> None:
    """One sub-phase of the fleet phase: ``build(probe, clock_now)`` makes
    the session and its servers (the probe watching each), the 16 requests
    replay through ``drive_replay`` with 4 clients, every stream logged as
    the client reads it. Checks every request done with its 32 tokens, the
    client's streams equal to the engine's outputs, token times in order
    and the first at the request's TTFT stamp, both attention kernels
    launched (counted from zero), every logit row finite; then
    ``check_more(session, trace)``. Prints walls, per-request TTFT/TPOT and
    peak memory beside the card."""
    import asyncio

    import torch

    from repro_torch.obs import EventType, TraceRecorder
    from repro_torch.serving.frontend import drive_replay
    from repro_torch.serving.router import RouterSession

    card = ctx["card"]
    trace = TraceRecorder()
    probe = _Probe()
    session, now = build(probe, trace)
    log = _StreamLog(session.submit, now)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _attention_launches(zero=True)

    async def run():
        async with session:
            await drive_replay(log.submit, pairs, clients=4)

    t0 = time.perf_counter()
    asyncio.run(run())
    wall = time.perf_counter() - t0
    launches = _attention_launches()
    finite = probe.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    outs = session.outputs if isinstance(session, RouterSession) else session.session.outputs
    first_tok = {}
    for e in trace.events:
        if e.type is EventType.TOKEN:
            first_tok.setdefault(e.rid, e.t)
    lag = 0.0
    for r, _ in pairs:
        got = outs.get(r.rid, [])
        check(r.phase.value == "done" and len(got) == r.output_len,
              f"fleet {label}: rid {r.rid} ended {r.phase.value} with {len(got)}/{r.output_len} "
              "tokens")
        check(log.tokens.get(r.rid) == got,
              f"fleet {label}: rid {r.rid} streamed {log.tokens.get(r.rid)} != outputs {got}")
        check(r.token_times == sorted(r.token_times) and len(r.token_times) == r.output_len,
              f"fleet {label}: rid {r.rid} token times out of order or short")
        check(r.first_token_time == r.token_times[0] == first_tok.get(r.rid)
              and r.ttft() == r.first_token_time - r.arrival,
              f"fleet {label}: rid {r.rid} first token at {r.token_times[0]}, TTFT stamp "
              f"{r.first_token_time}, first TOKEN event {first_tok.get(r.rid)}")
        lag = max(lag, log.first_seen[r.rid] - r.first_token_time)
        say(f"[fleet] {label} rid={r.rid} prompt={r.input_len} out={len(got)} "
            f"ttft={r.ttft():.4f}s tpot={r.mean_tpot():.5f}s [{card}]")
    check(finite, f"fleet {label}: a logit row was not finite")
    check(all(n > 0 for n in launches.values()),
          f"fleet {label}: a kernel never launched: {launches}")
    check_more(session, trace)
    ttft = sorted(r.ttft() for r, _ in pairs)
    tpot = sorted(r.mean_tpot() for r, _ in pairs)
    say(f"[fleet] {label}: {len(pairs)} requests in {wall:.3f} s; TTFT median "
        f"{ttft[len(ttft) // 2]:.4f} s max {ttft[-1]:.4f} s; TPOT median "
        f"{tpot[len(tpot) // 2]:.5f} s max {tpot[-1]:.5f} s; prefill chunks "
        f"{len(probe.chunk_s)}, decode steps {len(probe.step_s)}; launches {launches}; "
        f"streams equal outputs, first streamed token at most {lag:.4f} s after its stamp; "
        f"peak memory {peak:.2f} GiB; all logits finite [{card}]")


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_fleet(ctx) -> None:
    """llama3-8b at full width and depth in bf16, one parameter copy shared
    by every server, real clocks: the async frontend, a prefix-affinity
    router over 2 paged replicas, a 1P:1D disagg fleet and a fleet
    controller with a kill and queue-threshold autoscaling."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.smoke_workload import fleet_requests, smoke_engine_config
    from repro_torch.models import build_model
    from repro_torch.serving.clock import MonotonicClock
    from repro_torch.serving.disagg import DisaggFleetSession
    from repro_torch.serving.engine import DisaggServer
    from repro_torch.serving.fleetctl import FleetSession
    from repro_torch.serving.frontend import AsyncServeSession
    from repro_torch.serving.router import RouterSession

    dev, card = ctx["device"], ctx["card"]
    cfg = get_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"[fleet] {cfg.name} {cfg.dtype}, full width and depth, random weights (seed 0), "
        f"one copy shared by every server; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated [{card}]")

    def server(probe, page_size=None, clock=None):
        return probe.watch(DisaggServer(model, params, smoke_engine_config(page_size),
                                        clock=clock, device=dev))

    def traffic():
        return fleet_requests(cfg.vocab_size)

    # 1. the async frontend over one server
    def frontend(probe, trace):
        srv = server(probe)
        return AsyncServeSession(srv, trace=trace), srv.peek_now

    _fleet_run(ctx, "frontend", frontend, traffic(), lambda sess, tr: None)
    _free()

    # 2. prefix-affinity router over 2 paged replicas
    def router(probe, trace):
        srvs = [server(probe, page_size=64) for _ in range(2)]
        return (RouterSession(srvs, policy="prefix-affinity", prefix_block=64, trace=trace),
                srvs[0].peek_now)

    def router_checks(sess, trace):
        s = sess.summary()
        assigned, hits = s["routing"]["assigned"], s["prefix"]["hit_tokens"]
        check(min(assigned) > 0, f"fleet router: a replica was assigned nothing: {assigned}")
        check(hits > 0, "fleet router: no prefix hit tokens")
        say(f"[fleet] router: assigned {assigned}; prefix hit tokens {hits} of "
            f"{s['prefix']['lookup_tokens']} looked up")

    _fleet_run(ctx, "router", router, traffic(), router_checks)
    _free()

    # 3. 1 prefill + 1 decode server on one clock, no deflection
    def disagg(probe, trace):
        clock = MonotonicClock()
        p, d = server(probe, clock=clock), server(probe, clock=clock)
        return DisaggFleetSession([p], [d], deflection="never", trace=trace), p.peek_now

    def disagg_checks(sess, trace):
        from repro_torch.obs import EventType

        h = sess.core.handoff_summary()
        check(h["transfers_completed"] == 16 and h["cross_transfers"] == 16,
              f"fleet disagg: handoffs {h}")
        check(not sess.core.inflight and not sess.core.pending_handoff and not sess.core.has_work,
              "fleet disagg: work left in flight or pending")
        ready = {e.rid: e.data["ready_at"] for e in trace.events
                 if e.type is EventType.HANDOFF_START}
        for r in sess.session.requests:
            check(r.decode_start >= ready[r.rid] >= r.prefill_finish,
                  f"fleet disagg: rid {r.rid} decode start {r.decode_start} before its "
                  f"transfer was ready at {ready[r.rid]}")
        say(f"[fleet] disagg: transfers {h['transfers_completed']} (cross "
            f"{h['cross_transfers']}), {h['bytes_transferred'] / 2**30:.3f} GiB priced, queue wait "
            f"max {h['queue_wait_max']:.4f} s; every decode start >= its transfer-ready time")

    _fleet_run(ctx, "disagg", disagg, traffic(), disagg_checks)
    _free()

    # 4. fleet controller: 2 replicas, replica 0 killed at FLEET_KILL_AT s,
    # queue-threshold autoscaling between 1 and 3 replicas
    mem = {}

    def fleet(probe, trace):
        srvs = [server(probe) for _ in range(2)]
        sess = FleetSession(srvs, policy="least-queued", autoscaler="queue-threshold",
                            n_min=1, n_max=3, kill_schedule=[(FLEET_KILL_AT, 0)],
                            server_factory=lambda: server(probe), trace=trace)
        kill = sess.kill_replica

        async def kill_replica(index, reason="killed"):
            mem["before"] = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
            record = await kill(index, reason)
            torch.cuda.synchronize()
            mem["after"] = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
            return record

        sess.kill_replica = kill_replica
        return sess, srvs[1].peek_now  # replica 1 survives the kill

    def fleet_checks(sess, trace):
        f = sess.summary()["fleet"]
        check(f["kills"] == 1 and len(f["recoveries"]) == 1,
              f"fleet controller: kill not recorded: kills {f['kills']}, skipped "
              f"{f['kills_skipped']}")
        rec = f["recoveries"][0]
        check(rec["replica"] == 0 and rec["steps"], f"fleet controller: recovery {rec}")
        check(f["restored"] >= 1, "fleet controller: the kill restored no request")
        gib = {k: tuple(x / 2**30 for x in v) for k, v in mem.items()}
        say(f"[fleet] controller: replica 0 killed at t={rec['t']:.3f} s, restored "
            f"{len(rec['restored'])} on survivors (rids {rec['restored']}), rescheduled "
            f"{len(rec['rescheduled'])}; recovery plan "
            f"{[s[0] for s in rec['steps']]}; scale-ups {f['scale_ups']}, scale-downs "
            f"{f['scale_downs']}, decisions {[(d['action'], d['applied']) for d in f['decisions']]}; "
            f"memory allocated/peak before the kill {gib['before'][0]:.2f}/"
            f"{gib['before'][1]:.2f} GiB, after {gib['after'][0]:.2f}/{gib['after'][1]:.2f} GiB "
            f"[{card}]")

    _fleet_run(ctx, "controller", fleet, traffic(), fleet_checks)
    del params
    _free()


# ----------------------------------------------------------------------- eval
EVAL_N = 24
# virtual seconds on the churn cell's fleet clock at which replica 0 dies:
# requests are then in flight on it (the schedule on ManualClocks is the
# same on any card; the restored rids are printed)
EVAL_KILL_AT = 0.01
# the CPU test's cell keys (tests/test_torch_workloads.py), plus each fleet
# backend's block
EVAL_CELL_KEYS = {
    "scenario", "prefill", "decode", "backend", "wall_time_s", "n_requests",
    "n_completed", "attainment", "per_tenant", "per_class", "goodput", "shed",
    "cancelled",
}
EVAL_BLOCKS = {"sim": set(), "engine": set(), "async-engine": set(), "router": {"router"},
               "disagg": {"disagg"}, "churn": {"churn"}}


def _eval_config():
    from repro_torch.workloads import HarnessConfig

    return HarnessConfig(
        n_requests=EVAL_N, seed=0, engine_arch="llama3-8b", engine_max_prompt=1536,
        engine_max_output=32, engine_max_len=2048, engine_chunk_size=512, engine_max_slots=8,
        router_replicas=2, disagg_prefill=1, disagg_decode=1,
        churn_kills=((EVAL_KILL_AT, 0),), autoscaler_policy="queue-threshold",
        fleet_max_replicas=3,
    )


def _att(cell) -> str:
    a = cell["attainment"]
    return (f"attainment TTFT {a['ttft']:.4f} TPOT {a['tpot']:.4f} E2E {a['e2e']:.4f}, goodput "
            f"{cell['goodput']:.2f} tokens/s")


def phase_eval(ctx) -> None:
    """The harness's grid over all six backends on ManualClocks, then two
    realtime loadgen cells on one server, llama3-8b bf16 at full width."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import loadgen
    from repro_torch.models import build_model
    from repro_torch.workloads import BACKENDS, harness

    dev, card = ctx["device"], ctx["card"]
    t0 = time.perf_counter()
    model = build_model(get_config("llama3-8b"))  # bf16, the config's own dtype
    bundle = harness._EngineBundle("llama3-8b", device=dev, model=model,
                                   params=model.init(seed=0, device=dev)).build()
    torch.cuda.synchronize()
    say(f"[eval] bundle {bundle.cfg.name} {bundle.cfg.dtype}, {bundle.cfg.num_layers} layers, "
        f"random weights (seed 0), built in {time.perf_counter() - t0:.1f} s [{card}]")

    # A. the grid on the harness's own ManualClocks, launches counted per cell
    hcfg = _eval_config()
    evaluate_cell, counts = harness.evaluate_cell, {}

    def counted(scenario, prefill, decode, backend, **kw):
        _attention_launches(zero=True)
        probe = _Probe()
        try:
            cell = evaluate_cell(scenario, prefill, decode, backend, **kw)
        finally:
            finite = probe.close()
        counts[backend] = (_attention_launches(), finite)
        _free()
        return cell

    t0 = time.perf_counter()
    harness.evaluate_cell = counted
    try:
        report = harness.run_grid(["paper-longtail"], ["kairos-urgency"], ["kairos-slack"],
                                  BACKENDS, hcfg, device=dev, bundle=bundle)
    finally:
        harness.evaluate_cell = evaluate_cell
    t_grid = time.perf_counter() - t0
    check([c["backend"] for c in report["cells"]] == list(BACKENDS),
          f"eval grid: cells {[c['backend'] for c in report['cells']]}")
    for cell in report["cells"]:
        b = cell["backend"]
        launches, finite = counts[b]
        check(set(cell) == EVAL_CELL_KEYS | EVAL_BLOCKS[b],
              f"eval {b}: cell keys {sorted(cell)}")
        check(cell["n_requests"] == EVAL_N and cell["shed"]["total"] == 0
              and cell["cancelled"]["total"] == 0 and cell["n_completed"] == EVAL_N,
              f"eval {b}: {cell['n_completed']}/{cell['n_requests']} done, shed "
              f"{cell['shed']['total']}, cancelled {cell['cancelled']['total']}")
        if b != "sim":
            check(all(n > 0 for n in launches.values()),
                  f"eval {b}: a kernel never launched: {launches}")
            check(finite, f"eval {b}: a logit row was not finite")
        say(f"[eval] grid {b}: {cell['n_completed']}/{cell['n_requests']} done in "
            f"{cell['wall_time_s']:.3f} s; {_att(cell)} (virtual time); launches "
            f"{launches if b != 'sim' else 'none (cost model)'} [{card}]")
    cells = {c["backend"]: c for c in report["cells"]}
    h = cells["disagg"]["disagg"]["handoff"]
    check(h["transfers_completed"] == EVAL_N, f"eval disagg: handoffs {h}")
    say(f"[eval] grid disagg: {h['transfers_completed']} handoffs (cross "
        f"{h['cross_transfers']}), queue wait max {h['queue_wait_max']:.4f} s (virtual)")
    f = cells["churn"]["churn"]["fleet"]
    check(f["kills"] == 1 and len(f["recoveries"]) == 1,
          f"eval churn: kills {f['kills']}, skipped {f['kills_skipped']}")
    rec = f["recoveries"][0]
    check(rec["replica"] == 0 and rec["steps"], f"eval churn: recovery {rec}")
    say(f"[eval] grid churn: replica 0 killed at t={rec['t']:.4f} (virtual), restored "
        f"{rec['restored']}, rescheduled {rec['rescheduled']}; recovery plan "
        f"{[s[0] for s in rec['steps']]}; scale-ups {f['scale_ups']}, scale-downs "
        f"{f['scale_downs']}; assigned {cells['churn']['churn']['assigned']}")
    say(f"[eval] grid router: assigned {cells['router']['router']['assigned']}")
    say(f"[eval] grid of {len(report['cells'])} cells in {t_grid:.1f} s [{card}]")

    # B. real clocks: one server, the trace's arrivals in real seconds
    rt = dataclasses.replace(hcfg, engine_arrival_scale=1.0, engine_slo_ttft_scale=0.25,
                             engine_slo_tpot_scale=2.0)
    setup, seen = loadgen._engine_setup, {}

    def kept(*args, **kw):
        servers, pairs = setup(*args, **kw)
        seen["pairs"] = pairs
        return servers, pairs

    for prefill, decode in (("kairos-urgency", "kairos-slack"), ("fcfs", "continuous")):
        _attention_launches(zero=True)
        loadgen._engine_setup = kept
        try:
            rep = loadgen.run_loadgen("paper-longtail", prefill, decode, rt, realtime=True,
                                      device=dev, bundle=bundle)
        finally:
            loadgen._engine_setup = setup
        launches = _attention_launches()
        [cell] = rep["cells"]
        reqs = [r for r, _ in seen["pairs"]]
        terminal = ("done", "failed", "cancelled")
        check(all(r.phase.value in terminal for r in reqs),
              f"eval realtime {prefill}/{decode}: requests not terminal: "
              f"{[(r.rid, r.phase.value) for r in reqs if r.phase.value not in terminal]}")
        check(all(n > 0 for n in launches.values()),
              f"eval realtime {prefill}/{decode}: a kernel never launched: {launches}")
        done = [r for r in reqs if r.phase.value == "done"]
        ttft = sorted(r.ttft() for r in done)
        tpot = sorted(r.mean_tpot() for r in done if r.mean_tpot() is not None)
        decoded = sum(r.n_generated - 1 for r in done)
        wall = cell["wall_time_s"]
        say(f"[eval] realtime {prefill}/{decode}: {cell['n_completed']}/{cell['n_requests']} "
            f"done in {wall:.3f} s (arrivals over {reqs[-1].arrival:.3f} s); {_att(cell)}; "
            f"decode {decoded} tokens, {decoded / wall:.2f} tokens/s over the wall; TTFT median "
            f"{ttft[len(ttft) // 2]:.4f} s max {ttft[-1]:.4f} s; TPOT median "
            f"{tpot[len(tpot) // 2]:.5f} s max {tpot[-1]:.5f} s; launches {launches} [{card}]")
        _free()
    del bundle, model
    _free()


# --------------------------------------------------------------------- parity
def phase_parity(ctx) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import DisaggServer, EngineConfig, reference_generate

    # full width in f32, depth cut from 32 to 4 layers to bound the time
    cfg = get_config("llama3-8b").replace(dtype="float32", num_layers=4)
    model = build_model(cfg)
    params = model.init(seed=1, device=ctx["device"])
    rng = np.random.default_rng(1)
    # start + chunk_size <= max_len for every chunk (ROADMAP C1)
    prompts = [list(map(int, rng.integers(2, cfg.vocab_size, n))) for n in (17, 64, 130, 250)]
    max_len, n_new = 512, 8
    refs = [reference_generate(model, params, p, n_new, max_len, eos=-1) for p in prompts]
    runs = [("kairos-urgency", "kairos-slack", None), ("fcfs", "continuous", None),
            ("kairos-urgency", "kairos-slack", 64)]
    for pp, dp, ps in runs:
        ecfg = EngineConfig(max_slots=4, max_len=max_len, chunk_size=128, prefill_policy=pp,
                            decode_policy=dp, eos_token=-1, page_size=ps)
        outs = DisaggServer(model, params, ecfg, device=ctx["device"]).serve(
            _requests(prompts, n_new, 0.01, 60.0, 5.0))
        label = f"{pp}/{dp} {'paged' if ps else 'slot'}"
        for i, ref in enumerate(refs):
            check(outs[i] == ref, f"parity {label}: rid {i} tokens {outs[i]} != reference {ref}")
        say(f"[parity] {label}: tokens of {len(prompts)} requests equal reference_generate's")
    _session_parity(ctx, model, params, prompts, refs, max_len, n_new)
    say(f"[parity] llama3-8b f32, full width, depth cut 32 -> 4 layers [{ctx['card']}]")
    del params
    torch.cuda.empty_cache()
    _ssm_parity(ctx, "mamba2-130m", None)
    _ssm_parity(ctx, "zamba2-2.7b", 12)


# the virtual time at which the parity phase's fleet loses replica 0: both
# replicas are then mid-run (some requests decoding, some prefilling)
PARITY_KILL_AT = 0.03


def _session_parity(ctx, model, params, prompts, refs, max_len, n_new) -> None:
    """The session stack on the card in f32: every request's greedy tokens
    through the async frontend, a 2-replica router, a 1P:1D and a 2P:1D
    disagg fleet and a fleet controller that kills a replica mid-run equal
    reference_generate's. ManualClock(auto_step=1e-3): the schedule, and so
    which requests the kill catches, does not depend on the card's speed."""
    import asyncio

    from repro_torch.serving.clock import ManualClock
    from repro_torch.serving.disagg import DisaggFleetSession
    from repro_torch.serving.engine import DisaggServer, EngineConfig
    from repro_torch.serving.fleetctl import FleetSession
    from repro_torch.serving.frontend import AsyncServeSession
    from repro_torch.serving.router import RouterSession

    def server(clock=None, page_size=None):
        ecfg = EngineConfig(max_slots=4, max_len=max_len, chunk_size=128, eos_token=-1,
                            page_size=page_size)
        return DisaggServer(model, params, ecfg, device=ctx["device"],
                            clock=clock if clock is not None else ManualClock(auto_step=1e-3))

    def pools(n_prefill, n_decode):
        clock = ManualClock(auto_step=1e-3)
        srvs = [server(clock) for _ in range(n_prefill + n_decode)]
        return srvs[:n_prefill], srvs[n_prefill:]

    kinds = [
        ("async frontend", lambda: AsyncServeSession(server())),
        ("router, 2 paged replicas, prefix-affinity",
         lambda: RouterSession([server(page_size=64) for _ in range(2)],
                               policy="prefix-affinity", prefix_block=64)),
        ("disagg 1P:1D, never", lambda: DisaggFleetSession(*pools(1, 1), deflection="never")),
        ("disagg 2P:1D, slack-aware",
         lambda: DisaggFleetSession(*pools(2, 1), deflection="slack-aware")),
        (f"fleet controller, 2 replicas, replica 0 killed at t={PARITY_KILL_AT}",
         lambda: FleetSession([server(), server()], policy="round-robin",
                              autoscale_interval=0.0, kill_schedule=[(PARITY_KILL_AT, 0)])),
    ]
    for label, build in kinds:
        session = build()
        reqs = _requests(prompts, n_new, 0.01, 60.0, 5.0)

        async def run():
            async with session:
                return await session.replay(reqs, clients=2)

        outs = asyncio.run(run())
        for i, ref in enumerate(refs):
            check(outs[i] == ref, f"parity {label}: rid {i} tokens {outs[i]} != reference {ref}")
        extra = ""
        if isinstance(session, FleetSession):
            f = session.summary()["fleet"]
            check(f["kills"] == 1 and f["restored"] >= 1,
                  f"parity {label}: kills {f['kills']}, restored {f['restored']}")
            extra = f" (restored {f['restored']} on the survivor and re-prefilled there)"
        say(f"[parity] {label}: tokens of {len(prompts)} requests equal "
            f"reference_generate's{extra}")
        del session
        _free()


SSM_PARITY_TOL = 2e-4  # atol = rtol, as tests/test_models_numerics.py


def _ssm_parity(ctx, arch, num_layers) -> None:
    """float32 at full width: for prompts of 17, 130 and 250 tokens, the
    last-token logits of Model.prefill equal those of the same prompt fed
    token by token through Model.decode from a zero cache, and the 8 greedy
    tokens after each path (prefill handed off into a decode cache, and the
    token-by-token cache) are equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import handoff

    dev = ctx["device"]
    cfg = get_config(arch).replace(dtype="float32")
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    model = build_model(cfg)
    params = model.init(seed=1, device=dev)
    rng = np.random.default_rng(1)
    errs = []
    for n in (17, 130, 250):
        prompt = torch.tensor(rng.integers(2, cfg.vocab_size, n), device=dev)
        max_len = n + 8
        lg_pf, kv = model.prefill(params, dict(inputs=prompt[None]))
        c_pf = handoff(cfg, kv, model.init_cache(1, max_len, device=dev))
        c_dec = model.init_cache(1, max_len, device=dev)
        for t in range(n):
            lg_dec, c_dec = model.decode(params, prompt[None, t : t + 1],
                                         torch.tensor([t], device=dev), c_dec)
        err = _max_err(lg_dec, lg_pf)
        errs.append(err)
        check(bool(torch.allclose(lg_dec, lg_pf, rtol=SSM_PARITY_TOL, atol=SSM_PARITY_TOL)),
              f"parity {arch} prompt {n}: prefill vs token-by-token logits max err {err}")
        toks = []
        for lg, cache in ((lg_pf, c_pf), (lg_dec, c_dec)):
            tok, seq = torch.argmax(lg, -1), []
            for t in range(8):
                seq.append(int(tok))
                lg, cache = model.decode(params, tok[:, None], torch.tensor([n + t], device=dev),
                                         cache)
                tok = torch.argmax(lg, -1)
            toks.append(seq)
        check(toks[0] == toks[1], f"parity {arch} prompt {n}: greedy tokens after prefill "
              f"{toks[0]} != after token-by-token decode {toks[1]}")
    depth = (f"depth cut {get_config(arch).num_layers} -> {cfg.num_layers} layers" if num_layers
             else f"full depth ({cfg.num_layers} layers)")
    say(f"[parity] {arch} f32, full width, {depth}: prefill vs token-by-token decode logits max "
        f"abs err {', '.join(f'{e:.3e}' for e in errs)} for prompts of 17, 130, 250 tokens "
        f"(tol {SSM_PARITY_TOL}); 8 greedy tokens after each path equal [{ctx['card']}]")
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------------------ ssm
SSM_PROMPTS = (2048, 1536, 700, 130)  # right-padded to the longest, with valid_len
SSM_MAX_LEN, SSM_STEPS = 2080, 32


def phase_ssm(ctx) -> None:
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.ssd_scan.ops import SCALAR, TENSOR_CORE, ssd
    from repro_torch.models import build_model
    from repro_torch.models.transformer import handoff

    dev, card = ctx["device"], ctx["card"]
    kernels = {"ssd_scan": ssd, "prefill_attention": prefill_attention,
               "decode_attention": decode_attention}
    for arch in ("zamba2-2.7b", "mamba2-130m"):
        gc.collect()  # servers of earlier phases hold weights and caches in reference cycles
        torch.cuda.empty_cache()
        cfg = get_config(arch)  # full width and depth, bf16 (the config's own dtype)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        attn = (f", shared attention {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim} "
                f"after every {cfg.hybrid_period}" if cfg.hybrid_period else "")
        say(f"[ssm] {arch}: {cfg.num_layers} Mamba2 layers, d_model {cfg.d_model}, "
            f"{cfg.ssm_num_heads} SSM heads x {cfg.ssm_head_dim}, state {cfg.ssm_state_dim}{attn}, "
            f"vocab {cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.3f} B random parameters "
            f"(seed 0) in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        toks = np.zeros((len(SSM_PROMPTS), max(SSM_PROMPTS)), np.int64)
        for i, n in enumerate(SSM_PROMPTS):
            toks[i, :n] = rng.integers(2, cfg.vocab_size, n)
        inputs = torch.tensor(toks, device=dev)
        valid = torch.tensor(SSM_PROMPTS, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        ssd.route_launches = dict.fromkeys(ssd.route_launches, 0)
        t0 = time.perf_counter()
        logits, kv = model.prefill(params, dict(inputs=inputs), valid_len=valid)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = handoff(cfg, kv, model.init_cache(len(SSM_PROMPTS), SSM_MAX_LEN, device=dev))
        del kv
        finite = [torch.isfinite(logits).all()]
        tok, pos, out, step_s = torch.argmax(logits, -1), valid.clone(), [], []
        for _ in range(SSM_STEPS):
            t0 = time.perf_counter()
            logits, cache = model.decode(params, tok[:, None], pos, cache)
            tok = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite.append(torch.isfinite(logits).all())
            out.append(tok)
            pos = pos + 1
        launched = {name: k.launches for name, k in kernels.items()}  # prefill and decode
        by_route = dict(ssd.route_launches)
        finite.append(torch.isfinite(cache["state"]).all())
        peak = torch.cuda.max_memory_allocated() / 2**30
        out = torch.stack(out, 1)
        check(all(bool(f) for f in finite), f"[ssm] {arch}: a logit row or the state was not finite")
        check(tuple(out.shape) == (len(SSM_PROMPTS), SSM_STEPS), f"[ssm] {arch}: tokens {out.shape}")
        want = {"ssd_scan": cfg.num_layers}
        if cfg.hybrid_period:
            ns = cfg.num_layers // cfg.hybrid_period
            want.update(prefill_attention=ns, decode_attention=ns * SSM_STEPS)
        for name, n in want.items():
            check(launched[name] == n, f"[ssm] {arch}: {name} launched {launched[name]} times, "
                  f"expected {n}")
        check(by_route == {TENSOR_CORE: cfg.num_layers, SCALAR: 0},
              f"[ssm] {arch}: ssd_scan calls by route {by_route}, expected all "
              f"{cfg.num_layers} on {TENSOR_CORE}")
        ssd_ms = cfg.num_layers * ctx["ssd_device_ms"][arch]
        say(f"[ssm] {arch}: prefill of {len(SSM_PROMPTS)} prompts {list(SSM_PROMPTS)} "
            f"(right-padded to {max(SSM_PROMPTS)}) {1e3 * prefill_s:.2f} ms; handoff into "
            f"init_cache({len(SSM_PROMPTS)}, {SSM_MAX_LEN}); {SSM_STEPS} greedy decode steps mean "
            f"{1e3 * sum(step_s) / len(step_s):.2f} ms (first {1e3 * step_s[0]:.2f} ms); launches "
            f"{launched}, ssd_scan by route {by_route}; peak memory {peak:.2f} GiB; all logits "
            f"and states finite; request 3's first tokens {out[3, :8].tolist()} [{card}]")
        say(f"[ssm] {arch}: {cfg.num_layers} ssd_scan calls x {ctx['ssd_device_ms'][arch]:.4f} ms "
            f"(device alone at B={len(SSM_PROMPTS)} L={max(SSM_PROMPTS)}, kernels phase) = "
            f"{ssd_ms:.2f} ms of the {1e3 * prefill_s:.2f} ms prefill "
            f"({100 * ssd_ms / (1e3 * prefill_s):.1f}%) [{card}]")
        if arch == "zamba2-2.7b":
            ctx["launches"]["ssd_scan"] = launched["ssd_scan"]  # counts zeroed just before
        del params, cache, logits
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------- main
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1

    ctx: dict = {}
    t_start = time.perf_counter()
    try:
        for phase in (phase_device, phase_build, phase_kernels, phase_serve, phase_fleet,
                      phase_eval, phase_parity, phase_ssm):
            t0 = time.perf_counter()
            phase(ctx)
            name = phase.__name__.removeprefix("phase_")
            say(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        return 1
    say(f"[total] {time.perf_counter() - t_start:.1f} s")
    rows = ctx["kernel_rows"]
    for r in rows:
        r.pop("shape")
        # attention: the slot serve; ssd_scan: the zamba2 prefill; counts zeroed before each
        r["launches"] = ctx["launches"][r["name"]]
    say(json.dumps({"kernels": rows}))
    say(f"card: {ctx['card']}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
