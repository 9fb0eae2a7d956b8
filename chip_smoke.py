#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch/CUDA port builds, is right and
serves: the quickest check that ``repro_torch`` still starts on the card.

    python3 chip_smoke.py

Phases, each printed on its own lines:

  device   the card's name and power limit (nvidia-smi); TF32 off for
           float32 matmuls and convolutions, so f32 means f32
  build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
  kernels  every kernel against its plain PyTorch version on the card, over
           the sweep of tests/test_kernels.py (plus Dh=256) and at the serving
           shapes of llama3-8b (attention), zamba2-2.7b (attention at Dh=80,
           SSD scan), gemma2-9b (attention at Dh=256, prefill with logit cap
           50), chameleon-34b (decode at 8 query heads per KV head),
           seamless-m4t-medium (Dh=64, one query head per KV head: decode
           over the 4096-row encoder memory and a 512-row self cache, prefill
           of 16-token ragged target prefixes) and mamba2-130m (SSD scan),
           each in f32 (attention tol 2e-5, SSD
           1e-4) and bf16 (tol 2e-2; bf16 prefill also within 6e-3 in
           relative norm of the plain version in f32, logit cap included,
           and bf16 decode within BF16_DECODE_REL lane by lane, where the
           kernel run with planted faults, every kv_len one row short or
           the longest lane without its last tile or split, must land
           beyond twice that limit),
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
           phase's B=4. The prefill backward kernels (prefill_attention_bwd.cu;
           bf16 on wgmma, f32 on the scalar kernels) against their plain
           backward: 18 sweep cases (ragged q_pos offsets, kv_len short of
           the visible rows, every Dh, cap 50 at Dh=256, 8 query heads per KV
           head, Sq not a multiple of 64) and the training shapes of
           minicpm-2b (B=4 S=2048 36/36 Dh=64), llama3-8b (B=1 S=2048 32/8
           Dh=128) and gemma2-9b (B=1 S=2048 16/8 Dh=256, cap 50), f32 within
           2e-5 x max(1, max|ref|), bf16 dq, dk, dv within BWD_BF16_REL (1e-2)
           in relative norm of the plain backward in f32, where two faults
           planted in the plain version (D dropped from dS; the cap's chain
           factor dropped) must land beyond twice the limit; two calls on the
           same inputs bit-identical at each training shape, and NaN in K and
           V past kv_len leaving dq, dk, dv bit-identical (both dtypes);
           timed beside SDPA's backward, also at zamba2-2.7b's shared
           attention (B=4 S=2048 32/32 Dh=80). The SSD scan's backward
           kernels (ssd_scan_bwd.cu: ssd_state_bwd, ssd_chunk_bwd,
           ssd_bwd_reduce) against the plain backward (ssd_chunked_bwd in
           f32 from the exact states), after the route's forward wrote
           S_in: the forward's sweep (ragged L, L < Q, initial states with
           dinit, a nonzero final-state gradient, a partial head group) and
           the training microbatches of zamba2-2.7b (B=4 L=2048 H=80 P=N=64)
           and mamba2-130m (B=4 L=2048 H=24 P=64 N=128), f32 within 1e-4 x
           max(1, max|ref|), bf16 dx, ddt, dA, dB, dC, dinit within
           SSD_BWD_BF16_REL (1e-2) in relative norm, where two faults
           planted in the plain backward (dS not carried across the middle
           chunk; the reverse cumsum of dcums dropped) must land beyond
           twice the limit; two calls bit-identical; timed beside the plain
           backward and the bound (no library call computes it)
  train    training on the card: one train step of llama3-8b-smoke,
           minicpm-2b-smoke, mamba2-130m-smoke and zamba2-2.7b-smoke in f32
           at 1 and 2 microbatches on the card (the prefill kernels, the SSD
           scan and their backward kernels, each launched exactly as often
           as a step needs) against the CPU (loss within 2e-5, every grad
           leaf within 1e-4 in relative norm); a resume at smoke size
           bit-identical to an uninterrupted run (3 steps, an async
           checkpoint, a restore into fresh tensors, 1 step); then
           minicpm-2b and zamba2-2.7b whole in bf16 (random weights from a
           seed), each: SyntheticDataset(seq_len=2048, global_batch=8), 2
           microbatches, remat, 6 AdamW steps with WSD warm-up 2: every
           loss and grad norm finite, each step's kernel launches exact
           (minicpm-2b: the prefill backward 80 and forward 160; zamba2-2.7b:
           the SSD backward 108 and forward 216, the prefill backward 18 and
           forward 36; remat runs each forward twice), the last loss below
           the first and the first batch's loss lower after training; each
           step's time, tokens/s, model-FLOPs share of the card's dense bf16
           peak (`_train_flops`) and peak memory are printed, and one more
           step is profiled by kernel group (the global batch halves if the
           first step's peak passes 72 GB)
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
           (tol 2e-4) and the 8 greedy tokens after both paths are equal;
           gemma2-9b cut to 4 layers (local, global, local, global) and
           phi3.5-moe cut to 2 (at capacity factor 8, where nothing is
           dropped), engine tokens slot and paged equal reference_generate's,
           and gemma2's ring (a 4500-token prompt prefilled, handed into
           init_cache(1, 8192) and decoded 16 steps) gives the greedy tokens
           of a plain 8192-row cache under the window mask; phi3.5-moe's
           expert layer at full width, f32 and capacity factor 1.25, on a
           512-token chunk skewed so that experts overflow: moe_ffn on the
           card equals the same call on the CPU (MOE_CARD_REL), the expert
           choices are identical and choices were dropped
  ssm      zamba2-2.7b, then mamba2-130m, at full width and depth in bf16
           (random weights from a seed): Model.prefill of 4 right-padded
           prompts, handoff into a decode cache, 32 greedy Model.decode
           steps; the SSD scan (and for zamba2 both attention kernels) must
           launch once per layer, every SSD call on the tensor-core route;
           the SSD scan's share of the prefill (layers x its B=4 time)
  families the moe, vlm and alternating local/global families at full width
           in bf16 (random weights from a seed): gemma2-9b (all 42 layers)
           and phi3.5-moe-42b-a6.6b (16 of 32 layers; all 32 take ~84 GB in
           bf16, more than the card holds) each serve 8 requests of 64-3584
           prompt and 32 output tokens, 50 ms apart, at max_len 4096 (gemma2's
           window), chunk 512, under the Kairos policies, slot then paged:
           every request done, every logit row finite, both kernels launched
           at the model's head dim (256 for gemma2) and no call on a plain
           windowed path; gemma2's model API prefills 5120 + 4400 tokens (the
           local layers' window binds: the naive path), hands off into the
           ring of init_cache(2, 8192) and decodes 32 steps, every attention
           (the ring too) on the decode kernel; chameleon-34b (8 of 48
           layers) prefills from seeded embeddings, decodes 16 steps and
           serves 4 requests on tokens, both kernels at Hq/Hkv = 8
  encdec   seamless-m4t-medium at full width and depth (12 + 12 layers) in
           bf16 (random weights from a seed) through the model API: prefill
           of 4 sources of 4096 seeded frame embeddings with 16-token target
           prefixes (valid 16/12/8/4), exactly 12 prefill-kernel launches and
           24 calls on the plain non-causal path (encoder, cross attention);
           the handoff into a 512-row self cache (cross leaves at the
           encoder's length); 64 greedy decode steps, exactly 24
           decode-kernel launches a step (self and cross) and no plain call;
           every logit row finite. Then f32 at full width, 4 + 4 layers: the
           prefill of 16 target tokens plus 16 decode steps gives the last
           logits of the prefill of 32 (tol 2e-4), and the 8 greedy tokens
           after both are equal
  sched    the Kairos schedulers as device programs (core/device_sched.py)
           at n = 256 (benchmarks/kernel_bench.py's queue) and 4096 slots:
           urgency_select and slack_select (at kernel_bench's t = 10 s, where
           nothing packs, and at t = 9 s, where the pack binds) held against
           the host policies with tests/test_jax_sched_property.py's
           criteria, the sched_scan kernels bit for bit against their plain
           versions, each decision timed beside the host policy's (no winner
           asserted)

Every phase runs on every call. It imports nothing of JAX or of the JAX
package, exits non-zero when there is no card or when run outside the
repository, and prints the kernel table and the card line before the last
line, which is the ``{"ok": true, ...}`` record. The table's launches are
the slot serve's (attention), the minicpm-2b training run's (the prefill
backward, timed at its shape), the zamba2 prefill's (SSD scan, whose row
is timed at that prefill's shape, B=4 L=2048), the zamba2-2.7b training
run's (the SSD backward, timed at its microbatch) and the sched phase's
decisions (sched_scan, timed at 4096 slots), each counted from zero.
"""
from __future__ import annotations

import json
import math
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
# bf16 decode, relative to the f32 plain version (`_decode_ref_f32`), lane by
# lane (one sequence, all its heads): the 2e-2 elementwise tolerance is about
# as large as a typical output over a few thousand rows, so a lane missing its
# last tile or split would pass it. The kernels phase runs the kernel with such
# faults planted (every kv_len one row short; the longest lane's last tile of
# DECODE_TILE_ROWS, and its last split, left out) and checks that each moves
# the output by more than twice this limit. The limit is about twice the
# largest reading on an H100 (3.1e-3 over the sweep, the edges and the serving
# shapes); the planted faults there read 8.7e-2 and more.
BF16_DECODE_REL = 6e-3
DECODE_TILE_ROWS = 32  # BK in csrc/decode_attention.cu
# One row left out of a lane of kv_len rows moves it by about kv_len^-1/2 in
# relative norm, so the "one row short" fault is planted only where the
# shortest lane has at most this many rows (>= 3.1e-2, five times the limit);
# at the 4096-row cross attention of seamless-m4t-medium it would be 1.6e-2,
# too near twice the limit to tell from rounding. The tile and split faults
# are planted at every shape whose longest lane has more than one of them.
ROW_FAULT_MAX_LEN = 1024
SLEEP_CYCLES = 2_000_000  # ~1 ms of device spin at the H100's clock (`_time_ms`)
# bf16 prefill backward (dq, dk, dv), relative to the plain backward computed in
# f32 from the same bf16 inputs (`_bwd_f32`): the wgmma kernels round P to bf16
# before dV and dS to bf16 before dK and dQ, and sum in f32, so the reading is
# that rounding and the output's own, some 2e-3 to 4e-3 (tests/
# test_torch_attention_grad.py emulates the rounding points on the CPU). Dropping
# D from dS or the cap's chain factor moves dq and dk by 0.2 and more at the
# checked shapes (a CPU reading at S=512), far beyond twice the limit, which the
# kernels phase checks on the card.
BWD_BF16_REL = 1e-2


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


def _decode_ref_f32(q, k, v, kv_len, logit_cap=0.0):
    """The plain version of decode attention computed in f32 from the same
    (bf16) inputs, P rounded to bf16 before P.V as the kernel and the
    reference round it, the output left in f32: what the bf16 kernel is held
    to in relative norm (`BF16_DECODE_REL`)."""
    import torch

    from repro_torch.kernels.decode_attention.ref import NEG_INF

    b, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) / dh ** 0.5
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < kv_len[:, None]
    p = torch.softmax(torch.where(mask[:, None, None], s, NEG_INF), dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(torch.bfloat16).float(), v.float())
    return out.reshape(b, hq, dh)


def _lane_rel(out, ref):
    """||out_b - ref_b|| / ||ref_b|| of every sequence b (all its heads)."""
    return ((out.float() - ref.float()).flatten(1).norm(dim=1)
            / ref.float().flatten(1).norm(dim=1))


def _check_bf16_decode(out, ref32, kv_len, what) -> float:
    """The bf16 decode kernel's output against `_decode_ref_f32` in relative
    norm, every lane within `BF16_DECODE_REL`; returns the worst lane."""
    rel = _lane_rel(out, ref32)
    worst = int(rel.argmax())
    check(float(rel[worst]) <= BF16_DECODE_REL,
          f"decode_attention bf16 {what}: lane {worst} (kv_len {int(kv_len[worst])}) relative "
          f"error {float(rel[worst]):.3e} beyond {BF16_DECODE_REL}")
    return float(rel[worst])


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
    sweep_drel = 0.0  # bf16 decode, the same, worst lane

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    # the sweep of tests/test_kernels.py, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, skv, hq, hkv, dh in [
            (2, 128, 256, 4, 2, 64), (1, 64, 64, 8, 8, 128), (2, 100, 300, 6, 2, 32),
            (1, 256, 512, 4, 1, 128), (3, 32, 160, 4, 2, 16), (2, 96, 96, 4, 4, 80),
            (2, 100, 300, 16, 8, 256),
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
            (3, 600, 16, 8, 256),
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
            if dtype == torch.bfloat16:
                sweep_drel = max(sweep_drel, _check_bf16_decode(
                    out, _decode_ref_f32(q, k, v, kv_len), kv_len, str((b, s, hq, hkv, dh))))
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
        f"{cap_rel:.3e}; bf16 decode relative error, worst lane (limit {BF16_DECODE_REL}) "
        f"sweep max {sweep_drel:.3e}")
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
        # gemma2-9b (Dh=256, logit cap 50): a 512-token chunk at the end of a
        # 4096-row prefix, and decode of 8 lanes over 4096-row caches
        _prefill_row(gen, flush, 1, 512, 4096, 16, 8, 256, cap=50.0),
        _decode_row(gen, flush, 8, 4096, 16, 8, 256,
                    [4096, 3584, 3000, 2048, 1500, 777, 256, 65]),
        # chameleon-34b: 8 query heads per KV head
        _decode_row(gen, flush, 8, 2048, 64, 8, 128, [2048, 1900, 1536, 1024, 700, 512, 130, 64]),
        # seamless-m4t-medium (Dh=64, one query head per KV head), the encdec
        # phase's shapes: a decode step's cross attention over the 4096-row
        # encoder memory and its self attention over a 512-row cache, and the
        # decoder's prefill of 16-token target prefixes, ragged
        _decode_row(gen, flush, 4, 4096, 16, 16, 64, [4096] * 4),
        _decode_row(gen, flush, 4, 512, 16, 16, 64, [17, 40, 63, 80]),
        _prefill_row(gen, flush, 4, 16, 16, 16, 16, 64, kv_lens=[16, 12, 8, 4]),
    ]
    for r in rows + extra:
        if "rel_err" in r:
            rel = (f", relative error bf16 {r.pop('rel_err'):.3e} (limit {BF16_PREFILL_REL}; "
                   f"causal edge one row off: {r.pop('edge_rel'):.3e})")
        else:
            faults = r.pop("faults")
            rel = (f", relative error bf16 worst lane {r.pop('lane_rel'):.3e} (limit "
                   f"{BF16_DECODE_REL}; planted faults: every kv_len one row short "
                   f"{faults.get('row', float('nan')):.3e}, longest lane without its last tile "
                   f"{faults.get('tile', float('nan')):.3e}, without its last split "
                   f"{faults.get('split', float('nan')):.3e}; nan: not planted)")
        say(f"[kernels] {r['name']} at {r['shape']}: kernel {r['ms']:.4f} ms per call (device "
            f"alone {r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms (device alone {r['library_device_ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err bf16 {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}), f32 {r['max_abs_err_f32']:.3e} (tol {TOL['torch.float32']})"
            f"{rel} [{ctx['card']}]")
    rows.append(_ssd_checks(ctx, gen, flush))
    rows.append(_bwd_rows(ctx, gen, flush))
    rows.append(_ssd_bwd_rows(ctx, gen, flush))
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

    worst = worst_rel = 0.0
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
        check(_close(out, ref, dtype), f"decode_attention {dtype} kv_len {lens}: max err "
              f"{_max_err(out, ref)}")
        if dtype == torch.bfloat16:
            worst = _max_err(out, ref)
            worst_rel = _check_bf16_decode(out, _decode_ref_f32(q, k, v, kv_len), kv_len,
                                           f"kv_len {lens}")
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
        f"splits) and 5 splits within tolerance (bf16 max abs err {worst:.3e}, relative error "
        f"worst lane {worst_rel:.3e}, limit {BF16_DECODE_REL}); a sequence alone, "
        f"in a batch of 8 and in a cache cut to its kv_len bit-identical")


def _prefill_row(gen, flush, b, sq, skv, hq, hkv, dh, cap=0.0, kv_lens=None) -> dict:
    """prefill_attention against its plain version at one serving shape, the
    chunk at the end of the prefix (every kv_len Skv, or ``kv_lens``):
    checked in f32 (the tight tolerance) then bf16 (the serving dtype, which
    is timed, with SDPA as yardstick; SDPA takes no logit cap, so with
    ``cap`` it computes the uncapped function)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_ref

    dev = torch.device("cuda")
    q_pos = (torch.arange(sq, device=dev, dtype=torch.int32) + (skv - sq))[None].expand(b, sq)
    q_pos = q_pos.contiguous()
    kv_len = (torch.full((b,), skv, device=dev, dtype=torch.int32) if kv_lens is None
              else torch.tensor(kv_lens, device=dev, dtype=torch.int32))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(gen, (b, sq, hq, dh), dtype, 3.0 if cap else 1.0)
        k = _randn(gen, (b, skv, hkv, dh), dtype, 3.0 if cap else 1.0)
        v = _randn(gen, (b, skv, hkv, dh), dtype)
        out = prefill_attention(q, k, v, q_pos, kv_len, logit_cap=cap)
        ref = prefill_attention_ref(q, k, v, q_pos, kv_len, logit_cap=cap)
        errs[dtype] = _max_err(out, ref)
        check(_close(out, ref, dtype),
              f"prefill_attention at serving shape Dh={dh} {dtype}: max err {errs[dtype]}")
    rel = _check_bf16_prefill(out, q, k, v, q_pos, kv_len, f"at serving shape Dh={dh}", cap)
    # what the limit must catch: the plain version with its causal edge one row off
    edge_rel = _rel_err(_prefill_ref_f32(q, k, v, q_pos + 1, kv_len, cap),
                        _prefill_ref_f32(q, k, v, q_pos, kv_len, cap))
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
    kv_rows = int(torch.minimum(q_pos.long().amax(1) + 1, kv_len.long()).sum())  # rows read
    flops = 4 * hq * dh * visible
    nbytes = 2 * (2 * b * sq * hq * dh + 2 * kv_rows * hkv * dh) + 4 * (b * sq + b)
    return dict(
        name="prefill_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/prefill_attention.cu",
        replaces="src/repro/kernels/prefill_attention/kernel.py:83",
        max_abs_err=errs[torch.bfloat16], tol=TOL["torch.bfloat16"],
        max_abs_err_f32=errs[torch.float32],
        rel_err=rel, edge_rel=edge_rel,
        ms=_time_ms(lambda: prefill_attention(q, k, v, q_pos, kv_len, logit_cap=cap), iters=20,
                    flush=flush),
        device_ms=_time_ms(lambda: prefill_attention(q, k, v, q_pos, kv_len, logit_cap=cap),
                           iters=20, flush=flush, device_only=True),
        plain_ms=_time_ms(lambda: prefill_attention_ref(q, k, v, q_pos, kv_len, logit_cap=cap),
                          iters=5, flush=flush),
        library_ms=lib(False), library_device_ms=lib(True),
        **_bound(flops, nbytes, "torch.bfloat16"),
        shape=(f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} bf16, q_pos {skv - sq}.."
               f"{skv - 1}" + (f", kv_len {kv_lens}" if kv_lens else "")
               + (f", logit cap {cap} (SDPA uncapped)" if cap else "")),
    )


def _decode_row(gen, flush, b, s, hq, hkv, dh, kv_lens) -> dict:
    """decode_attention against its plain version at one serving shape, f32
    then bf16 (timed, with SDPA as yardstick); bf16 also lane by lane in
    relative norm against the f32 plain version, where the kernel run with
    a planted fault (every kv_len one row short; the longest lane without
    its last tile, or without its last split) must land beyond twice the
    limit."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import SPLIT_ROWS, decode_attention_ref

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
    ref32 = _decode_ref_f32(q, k, v, kv_len)
    rel = _check_bf16_decode(out, ref32, kv_len, f"at serving shape Dh={dh} Hq/Hkv={hq // hkv}")
    longest = int(kv_len.argmax())
    faults = {}
    if int(kv_len.min()) <= ROW_FAULT_MAX_LEN:
        faults["row"] = float(_lane_rel(decode_attention(q, k, v, (kv_len - 1).clamp_min(1)),
                                        ref32).max())
    for name, rows in (("tile", DECODE_TILE_ROWS), ("split", SPLIT_ROWS)):
        if int(kv_len[longest]) <= rows:
            continue  # the lane has one tile (split): nothing to leave out
        cut = kv_len.clone()
        cut[longest] -= rows
        faults[name] = float(_lane_rel(decode_attention(q, k, v, cut), ref32)[longest])
    check(min(faults.values()) > 2 * BF16_DECODE_REL,
          f"decode_attention Dh={dh}: planted faults move the output by {faults}, not all "
          f"clearly beyond {BF16_DECODE_REL}")
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
        lane_rel=rel, faults=faults,
        ms=_time_ms(lambda: decode_attention(q, k, v, kv_len), iters=50, flush=flush),
        device_ms=_time_ms(lambda: decode_attention(q, k, v, kv_len), iters=50, flush=flush,
                           device_only=True),
        plain_ms=_time_ms(lambda: decode_attention_ref(q, k, v, kv_len), iters=10,
                          flush=flush),
        library_ms=lib(False), library_device_ms=lib(True),
        **_bound(flops, nbytes, "torch.bfloat16"),
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} bf16, kv_len {kv_len.tolist()}",
    )


# ------------------------------------------------------- prefill backward
def _bwd_f32(q, k, v, out, lse, dout, q_pos, kv_len, cap, fault=None):
    """The plain backward of prefill attention in f32 from the same inputs
    (what the bf16 backward kernels are held to in relative norm), or, with
    ``fault``, the same with one term planted wrong: "D" drops D =
    rowsum(dO * O) from dS, "cap" drops the cap's chain factor 1 - (s/cap)^2.
    The faults show that `BWD_BF16_REL` catches such a kernel."""
    import torch

    from repro_torch.kernels.prefill_attention.ref import NEG_INF

    q, k, v, out, dout = (t.float() for t in (q, k, v, out, dout))
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    kr, vr = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / dh ** 0.5
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    kvp = torch.arange(skv, device=q.device)
    mask = ((kvp[None, None, :] <= q_pos[:, :, None])
            & (kvp[None, None, :] < kv_len[:, None, None]))[:, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, vr)
    d = (dout * out).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp if fault == "D" else dp - d)
    del dp
    if cap > 0.0 and fault != "cap":
        ds = ds * torch.where(mask, 1.0 - (s / cap) ** 2, 0.0)
    del s
    ds = ds / dh ** 0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).reshape(b, skv, hkv, rep, dh).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout).reshape(b, skv, hkv, rep, dh).sum(3)
    return dq, dk, dv


def _bwd_inputs(gen, b, sq, skv, hq, hkv, dh, cap, dtype, offs=None, kv_lens=None):
    """q, k, v, dO in ``dtype`` (q, k scaled by 3 under a cap, so it bites),
    q_pos at offsets ``offs`` (the end of the prefix where None), kv_len."""
    import torch

    dev = torch.device("cuda")
    sc = 3.0 if cap else 1.0
    q, k = _randn(gen, (b, sq, hq, dh), dtype, sc), _randn(gen, (b, skv, hkv, dh), dtype, sc)
    v, do = _randn(gen, (b, skv, hkv, dh), dtype), _randn(gen, (b, sq, hq, dh), dtype)
    offs = (torch.full((b,), skv - sq, device=dev, dtype=torch.int32) if offs is None
            else torch.tensor(offs, device=dev, dtype=torch.int32))
    q_pos = (offs[:, None] + torch.arange(sq, device=dev, dtype=torch.int32)).contiguous()
    kv_len = ((offs + sq).to(torch.int32) if kv_lens is None
              else torch.tensor(kv_lens, device=dev, dtype=torch.int32))
    return q, k, v, do, q_pos, kv_len


def _bwd_check(gen, b, sq, skv, hq, hkv, dh, cap=0.0, offs=None, kv_lens=None,
               faults=False) -> dict:
    """The backward kernels against their plain version at one shape: f32
    within 2e-5 x max(1, max|ref|), bf16 dq, dk, dv each within
    `BWD_BF16_REL` in relative norm of the plain backward in f32; with
    ``faults`` the planted faults of `_bwd_f32` must land beyond twice that
    limit. Returns the readings and the bf16 inputs (for timing)."""
    import torch

    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention_bwd,
        prefill_attention_fwd,
    )
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_bwd_ref

    what = f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} cap={cap}"
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, q_pos, kv_len = _bwd_inputs(gen, b, sq, skv, hq, hkv, dh, cap, dtype, offs,
                                                 kv_lens)
        out, lse = prefill_attention_fwd(q, k, v, q_pos, kv_len, logit_cap=cap)
        got = prefill_attention_bwd(q, k, v, out, lse, do, q_pos, kv_len, logit_cap=cap)
        if dtype == torch.float32:
            ref = prefill_attention_bwd_ref(q, k, v, out, lse, do, q_pos, kv_len, logit_cap=cap)
            errs = [_max_err(g, r) / max(1.0, float(r.abs().max())) for g, r in zip(got, ref, strict=True)]
            res["f32"] = max(errs)
            check(res["f32"] <= TOL["torch.float32"], f"prefill_attention_bwd f32 {what}: "
                  f"max abs err / max(1, max|ref|) of dq, dk, dv {errs}")
            del ref
        else:
            ref = _bwd_f32(q, k, v, out, lse, do, q_pos, kv_len, cap)
            rels = [_rel_err(g, r) for g, r in zip(got, ref, strict=True)]
            res["bf16"] = max(rels)
            check(res["bf16"] <= BWD_BF16_REL, f"prefill_attention_bwd bf16 {what}: relative "
                  f"error of dq, dk, dv {rels} beyond {BWD_BF16_REL}")
            res["max_abs_err"] = max(_max_err(g, r) for g, r in zip(got, ref, strict=True))
            if faults:
                for fault in ("D", "cap") if cap else ("D",):
                    bad = _bwd_f32(q, k, v, out, lse, do, q_pos, kv_len, cap, fault)
                    moved = min(_rel_err(x, r) for x, r in zip(bad[:2], ref[:2], strict=True))  # dq, dk
                    res[f"fault_{fault}"] = moved
                    check(moved > 2 * BWD_BF16_REL, f"prefill_attention_bwd {what}: the fault "
                          f"{fault} moves dq, dk by {moved:.3e}, not clearly beyond "
                          f"{BWD_BF16_REL}")
                    del bad
            res["inputs"] = (q, k, v, do, q_pos, kv_len, out, lse)
            del ref
    return res


def _bwd_sweep(gen) -> None:
    """The forward sweep's shapes for the backward, f32 and bf16: q_pos at
    ragged offsets, kv_len cut short of the visible rows on the second of
    each pair, every Dh of HEAD_DIMS, a cap of 50 at Dh = 256, 8 query heads
    per KV head, and Sq a multiple of neither 64 nor 128 at Dh = 128 (the
    wgmma kernels' 64-row query tiles and 128-row blocks)."""
    import torch

    worst = {"f32": 0.0, "bf16": 0.0}
    cases = [
        (2, 128, 256, 4, 2, 64, 0.0), (1, 64, 64, 8, 8, 128, 0.0), (2, 100, 300, 6, 2, 32, 0.0),
        (1, 256, 512, 4, 1, 128, 0.0), (3, 32, 160, 4, 2, 16, 0.0), (2, 96, 96, 4, 4, 80, 0.0),
        (2, 100, 300, 16, 8, 256, 50.0), (2, 96, 200, 32, 4, 64, 0.0),
        (2, 200, 333, 8, 4, 128, 0.0),
    ]
    for b, sq, skv, hq, hkv, dh, cap in cases:
        offs = torch.randint(0, skv - sq + 1, (b,), generator=gen, device="cuda").tolist()
        for kv_lens in (None, [max(1, o + sq - 7) for o in offs]):
            r = _bwd_check(gen, b, sq, skv, hq, hkv, dh, cap, offs=offs, kv_lens=kv_lens)
            worst = {k: max(v, r[k]) for k, v in worst.items()}
    say(f"[kernels] prefill_attention_bwd sweep ok ({2 * len(cases)} cases: ragged q_pos offsets, "
        f"kv_len past and short of the visible rows, every Dh of HEAD_DIMS, cap 50 at Dh=256, "
        f"Hq/Hkv = 8, Sq = 200 at Dh=128): f32 max abs err / max(1, max|ref|) {worst['f32']:.3e} "
        f"(limit {TOL['torch.float32']}), bf16 relative error {worst['bf16']:.3e} (limit "
        f"{BWD_BF16_REL})")


def _bwd_nan_tail(gen) -> None:
    """NaN in K and V past kv_len (kv_len ending inside a tile, each sequence
    its own) leaves dq, dk and dv bit-identical, f32 and bf16: the backward
    kernels never read those rows."""
    import torch

    from repro_torch.kernels.prefill_attention.ops import (
        prefill_attention_bwd,
        prefill_attention_fwd,
    )

    lens = [237, 150]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, q_pos, kv_len = _bwd_inputs(gen, 2, 100, 300, 8, 2, 128, 0.0, dtype,
                                                 offs=[n - 100 for n in lens])
        out, lse = prefill_attention_fwd(q, k, v, q_pos, kv_len)
        clean = prefill_attention_bwd(q, k, v, out, lse, do, q_pos, kv_len)
        kn, vn = k.clone(), v.clone()
        for i, n in enumerate(lens):
            kn[i, n:] = float("nan")
            vn[i, n:] = float("nan")
        tail = prefill_attention_bwd(q, kn, vn, out, lse, do, q_pos, kv_len)
        check(all(torch.equal(a, c) for a, c in zip(clean, tail, strict=True)),
              f"prefill_attention_bwd {dtype}: NaN past kv_len changed dq, dk or dv")
    say(f"[kernels] prefill_attention_bwd edges ok: NaN in K and V past kv_len {lens} leaves dq, "
        f"dk, dv bit-identical (f32 and bf16)")


def _prefill_bwd_row(ctx, gen, flush, b, s, hq, hkv, dh, cap=0.0, tag="") -> dict:
    """The backward kernels at one training shape (a whole causal sequence
    of S tokens): checked in f32 and bf16 with the planted faults, bf16
    timed after an L2 flush (per call and device alone) beside the plain
    backward and SDPA's backward (flash, is_causal; uncapped under a cap)
    as yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.prefill_attention.ops import prefill_attention_bwd
    from repro_torch.kernels.prefill_attention.ref import prefill_attention_bwd_ref

    r = _bwd_check(gen, b, s, s, hq, hkv, dh, cap, faults=True)
    q, k, v, do, q_pos, kv_len, out, lse = r.pop("inputs")

    def kernel():
        return prefill_attention_bwd(q, k, v, out, lse, do, q_pos, kv_len, logit_cap=cap)

    first, again = kernel(), kernel()
    check(all(torch.equal(x, y) for x, y in zip(first, again, strict=True)),
          f"prefill_attention_bwd at B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh}: two calls on the same "
          f"inputs differ")
    del first, again

    def plain():
        prefill_attention_bwd_ref(q, k, v, out, lse, do, q_pos, kv_len, logit_cap=cap)

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)

    def lib():
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    visible = b * s * (s + 1) // 2
    flops = 5 * 2 * hq * dh * visible
    nbytes = 2 * (4 * b * s * hq * dh + 4 * b * s * hkv * dh) + 4 * b * hq * s + 4 * (b * s + b)
    row = dict(
        name="prefill_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/prefill_attention_bwd.cu",
        replaces="src/repro/models/layers.py:213 (XLA's autodiff of the plain attention; the "
                 "Pallas kernel has no gradient)",
        max_abs_err=r["max_abs_err"], rel_err=r["bf16"], rel_limit=BWD_BF16_REL,
        ms=_time_ms(kernel, iters=5, flush=flush),
        device_ms=_time_ms(kernel, iters=5, flush=flush, device_only=True),
        plain_ms=_time_ms(plain, iters=2, flush=flush),
        library_ms=_time_ms(lib, iters=10, flush=flush),
        library_device_ms=_time_ms(lib, iters=10, flush=flush, device_only=True),
        **_bound(flops, nbytes, "torch.bfloat16"),
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} Dh={dh} bf16, causal" + (
            f", logit cap {cap} (SDPA uncapped)" if cap else ""),
    )
    faults = ", ".join(f"{f} dropped {r[f'fault_{f}']:.3e}" for f in ("D", "cap")
                       if f"fault_{f}" in r)
    say(f"[kernels] prefill_attention_bwd{tag} (CUDA C++, wgmma for bf16; f32 scalar) at "
        f"{row['shape']}: kernels {row['ms']:.4f} ms per call (device alone "
        f"{row['device_ms']:.4f} ms; two calls bit-identical), plain {row['plain_ms']:.4f} ms, sdpa "
        f"backward {row['library_ms']:.4f} ms (device alone {row['library_device_ms']:.4f} ms), "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); f32 max abs err / max(1, "
        f"max|ref|) {r['f32']:.3e} (limit {TOL['torch.float32']}); bf16 relative error "
        f"{r['bf16']:.3e} (limit {BWD_BF16_REL}; planted faults, dq and dk moved by at least: "
        f"{faults}) [{ctx['card']}]")
    del q, k, v, do, out, lse, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return row


def _bwd_rows(ctx, gen, flush) -> dict:
    """The sweep, then the rows at minicpm-2b's training shape (the kernel
    table's row: the train phase's main path), llama3-8b's (GQA 4:1, Dh=128)
    and gemma2-9b's (Dh=256, cap 50)."""
    _bwd_sweep(gen)
    _bwd_nan_tail(gen)
    row = _prefill_bwd_row(ctx, gen, flush, 4, 2048, 36, 36, 64, tag=" (minicpm-2b)")
    _prefill_bwd_row(ctx, gen, flush, 1, 2048, 32, 8, 128, tag=" (llama3-8b)")
    _prefill_bwd_row(ctx, gen, flush, 1, 2048, 16, 8, 256, cap=50.0, tag=" (gemma2-9b)")
    # zamba2-2.7b's shared attention at its training microbatch (the train phase's hybrid run)
    _prefill_bwd_row(ctx, gen, flush, 4, 2048, 32, 32, 80, tag=" (zamba2-2.7b)")
    return row


# ------------------------------------------------------------- SSD backward
SSD_BWD_F32_TOL = 1e-4  # x max(1, max|ref|): the forward's f32 tolerance
# (B, L, H, P, N, chunk, initial state): the forward's sweep and route
# shapes for the backward: ragged L, L < Q, initial states (dinit), a head
# count whose last head group of ssd_chunk_bwd is partial (20 heads)
SSD_BWD_SWEEP = [
    (2, 256, 4, 64, 32, 64, False), (1, 100, 2, 32, 16, 32, True), (2, 128, 8, 16, 64, 128, False),
    (2, 300, 4, 64, 128, 128, True), (2, 50, 4, 32, 32, 64, True), (1, 100, 3, 64, 128, 128, False),
    (1, 7, 3, 16, 16, 128, True), (4, 2048, 20, 64, 64, 128, True), (2, 2048, 24, 32, 128, 64, False),
]
# the training microbatches of the train phase's models (B=4 of global batch 8, 2 microbatches)
SSD_BWD_TRAIN = {"zamba2-2.7b": (4, 2048, 80, 64, 64, 128), "mamba2-130m": (4, 2048, 24, 64, 128, 128)}
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _ssd_bwd_ref(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal, fault=None):
    """The plain backward of the SSD scan in f32 from the same inputs and the
    exact states (what the kernels are held to), or, with ``fault``, the same
    with one step planted wrong: "dS" leaves the state's gradient uncarried
    across the middle chunk boundary (the two halves are differentiated
    apart, the first from a zero dS), "cumsum" drops the reverse cumsum of
    dcums (da = dcums). The faults show that `SSD_BWD_BF16_REL` catches
    such a kernel."""
    import torch

    from repro_torch.kernels.ssd_scan import ref

    xf, Bf, Cf, dyf = (t.float() for t in (x, Bm, Cm, dy))
    q = min(chunk, x.shape[1])
    if fault == "dS":
        cut = (-(-x.shape[1] // q) // 2) * q
        _, s_cut = ref.ssd_chunked(xf[:, :cut], dt[:, :cut], A, Bf[:, :cut, None],
                                   Cf[:, :cut, None], q, s0)
        left = ref.ssd_chunked_bwd(xf[:, :cut], dt[:, :cut], A, Bf[:, :cut], Cf[:, :cut], q, s0,
                                   None, dyf[:, :cut], None)
        right = ref.ssd_chunked_bwd(xf[:, cut:], dt[:, cut:], A, Bf[:, cut:], Cf[:, cut:], q,
                                    s_cut, None, dyf[:, cut:], dfinal)
        dx, ddt, dB, dC = (torch.cat([left[i], right[i]], dim=1) for i in (0, 1, 3, 4))
        return dx, ddt, left[2] + right[2], dB, dC, left[5]
    plain = ref._reverse_cumsum
    if fault == "cumsum":
        ref._reverse_cumsum = lambda t, dim: t
    try:
        return ref.ssd_chunked_bwd(xf, dt, A, Bf, Cf, q, s0, None, dyf, dfinal)
    finally:
        ref._reverse_cumsum = plain


def _ssd_bwd_check(gen, b, l, h, p, n, chunk, with_s0, dtype, faults=False) -> dict:
    """The SSD backward kernels against `_ssd_bwd_ref` at one shape, after
    the route's forward wrote S_in, with an initial state where asked and a
    nonzero gradient of the final state: f32 within SSD_BWD_F32_TOL x max(1,
    max|ref|), bf16 dx, ddt, dA, dB, dC and dinit each within
    `SSD_BWD_BF16_REL` in relative norm; with ``faults`` (bf16) both
    planted faults must land beyond twice that limit. Returns the readings
    and the inputs (for timing)."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import SSD_BWD_BF16_REL, route, ssd_bwd, ssd_fwd

    what = f"B={b} L={l} H={h} P={p} N={n} Q={chunk}{' init_state' if with_s0 else ''} {dtype}"
    x, dt, A, Bm, Cm = _ssd_inputs(gen, b, l, h, p, n, dtype)
    s0 = _randn(gen, (b, h, p, n), torch.float32) if with_s0 else None
    dy, dfinal = _randn(gen, (b, l, h, p), dtype), _randn(gen, (b, h, p, n), torch.float32)
    _, _, s_in = ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk, init_state=s0)
    got = ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, dfinal, chunk=chunk, init_state=s0)
    ref = _ssd_bwd_ref(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal)
    res = dict(route=route(dtype, p, n, chunk), inputs=(x, dt, A, Bm, Cm, s_in, dy, dfinal))
    if dtype == torch.float32:
        errs = [_max_err(g, r) / max(1.0, float(r.abs().max())) for g, r in zip(got, ref, strict=True)]
        res["f32"] = max(errs)
        check(res["f32"] <= SSD_BWD_F32_TOL, f"ssd_scan_bwd {what}: max abs err / max(1, max|ref|) "
              f"of {SSD_BWD_NAMES}: {errs}")
        return res
    rels = [_rel_err(g, r) for g, r in zip(got, ref, strict=True)]
    res["bf16"] = max(rels)
    res["max_abs_err"] = max(_max_err(g, r) for g, r in zip(got, ref, strict=True))
    check(res["bf16"] <= SSD_BWD_BF16_REL, f"ssd_scan_bwd {what}: relative error of "
          f"{SSD_BWD_NAMES}: {rels} beyond {SSD_BWD_BF16_REL}")
    if faults:  # each moves every gradient it reaches: the least of those is reported
        for fault, reached in (("dS", (0, 1, 2, 3)), ("cumsum", (1, 2))):
            bad = _ssd_bwd_ref(x, dt, A, Bm, Cm, chunk, s0, dy, dfinal, fault)
            moved = min(_rel_err(bad[i], ref[i]) for i in reached)
            res[f"fault_{fault}"] = moved
            check(moved > 2 * SSD_BWD_BF16_REL, f"ssd_scan_bwd {what}: the fault {fault} moves "
                  f"{[SSD_BWD_NAMES[i] for i in reached]} by {moved:.3e}, not clearly beyond "
                  f"{SSD_BWD_BF16_REL}")
            del bad
    return res


def _ssd_bwd_work(b, l, h, p, n, chunk, esize):
    """(operations, bytes) of one SSD backward: per (batch, head, chunk of q
    rows) 2 q^2 (2 P + 3 N) (G, dy.x^T, M^T dy, dG B, dG^T C) + 8 q P N (the
    four state products); x, dy and dx, S_in (f32, one state per chunk), dt
    and ddt, A and dA, B, C, dB and dC once, as training calls it (no initial
    state, the final state unused)."""
    q = min(chunk, l)
    rows = [q] * (l // q) + ([l % q] if l % q else [])
    flops = b * h * sum(2 * r * r * (2 * p + 3 * n) + 8 * r * p * n for r in rows)
    nbytes = (esize * (3 * b * l * h * p + 4 * b * l * n) + 4 * b * len(rows) * h * p * n
              + 4 * (2 * b * l * h + 2 * h))
    return flops, nbytes


def _ssd_bwd_rows(ctx, gen, flush) -> dict:
    """The SSD backward kernels (ssd_scan_bwd.cu) against their plain
    backward: the sweep in f32 and bf16, then the training microbatches of
    zamba2-2.7b (the kernel table's row: the train phase's hybrid run) and
    mamba2-130m with the planted faults, two calls bit-identical, timed (per
    call after an L2 flush, and device alone) beside the plain backward and
    the bound. No single PyTorch call computes this function: no library
    time."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import SSD_BWD_BF16_REL, ssd_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

    worst = {"f32": 0.0, "bf16": 0.0}
    for case in SSD_BWD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            r = _ssd_bwd_check(gen, *case, dtype)
            key = "f32" if dtype == torch.float32 else "bf16"
            worst[key] = max(worst[key], r[key])
    say(f"[kernels] ssd_scan_bwd sweep ok ({2 * len(SSD_BWD_SWEEP)} cases: ragged L, L < Q, "
        f"initial states (dinit), a nonzero final-state gradient, a partial head group, every P "
        f"and N): f32 max abs err / max(1, max|ref|) {worst['f32']:.3e} (limit "
        f"{SSD_BWD_F32_TOL}), bf16 relative error of dx, ddt, dA, dB, dC, dinit "
        f"{worst['bf16']:.3e} (limit {SSD_BWD_BF16_REL})")
    row = None
    for arch, (b, l, h, p, n, chunk) in SSD_BWD_TRAIN.items():
        f32 = _ssd_bwd_check(gen, b, l, h, p, n, chunk, False, torch.float32)
        del f32["inputs"]
        r = _ssd_bwd_check(gen, b, l, h, p, n, chunk, False, torch.bfloat16, faults=True)
        x, dt, A, Bm, Cm, s_in, dy, _ = r.pop("inputs")

        def kernel():  # as training calls it: no initial state, the final state unused
            return ssd_bwd(x, dt, A, Bm, Cm, s_in, dy, None, chunk=chunk, with_dinit=False)

        first, again = kernel(), kernel()
        check(all(torch.equal(u, v) for u, v in zip(first[:5], again[:5], strict=True)),
              f"ssd_scan_bwd at {arch}: two calls on the same inputs differ")
        del first, again

        def plain():
            ssd_chunked_bwd(x, dt, A, Bm, Cm, chunk, None, s_in, dy, None)

        t = dict(ms=_time_ms(kernel, iters=10, flush=flush),
                 device_ms=_time_ms(kernel, iters=10, flush=flush, device_only=True),
                 plain_ms=_time_ms(plain, iters=3, flush=flush),
                 kernels=_kernel_ms(kernel, ("ssd_state_bwd", "ssd_chunk_bwd", "ssd_bwd_reduce")),
                 **_bound(*_ssd_bwd_work(b, l, h, p, n, chunk, 2), "torch.bfloat16"))
        k = t["kernels"]
        say(f"[kernels] ssd_scan_bwd ({arch}) at B={b} L={l} H={h} P={p} N={n} Q={chunk} bf16 "
            f"(forward route {r['route']}): kernels {t['ms']:.4f} ms per call (device alone "
            f"{t['device_ms']:.4f} ms: ssd_state_bwd {k['ssd_state_bwd']:.4f} + ssd_chunk_bwd "
            f"{k['ssd_chunk_bwd']:.4f} + ssd_bwd_reduce {k['ssd_bwd_reduce']:.4f} ms profiled; two "
            f"calls bit-identical), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), library none; f32 max abs err / max(1, max|ref|) "
            f"{f32['f32']:.3e} (limit {SSD_BWD_F32_TOL}); bf16 relative error {r['bf16']:.3e} "
            f"(limit {SSD_BWD_BF16_REL}; planted faults: dS not carried across the middle chunk "
            f"moves dx, ddt, dA, dB by at least {r['fault_dS']:.3e}, the reverse cumsum of dcums "
            f"dropped moves ddt, dA by at least {r['fault_cumsum']:.3e}) [{ctx['card']}]")
        if row is None:
            row = dict(
                name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                replaces="src/repro/models/ssm.py:64 (XLA's autodiff of the plain scan "
                         "ssd_chunked; the Pallas kernel has no gradient)",
                max_abs_err=r["max_abs_err"], rel_err=r["bf16"], rel_limit=SSD_BWD_BF16_REL,
                ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"], library_ms=None,
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                shape=f"{arch} B={b} L={l} H={h} P={p} N={n} Q={chunk} bf16")
        del x, dt, A, Bm, Cm, s_in, dy
        torch.cuda.empty_cache()
    return row


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


def _kernel_ms(call, names) -> dict:
    """Device time alone of each kernel ``call`` launches whose name holds
    one of ``names``, mean over 10 calls under torch.profiler, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.self_device_time_total > 0:
                out[name] = e.self_device_time_total / e.count / 1e3
    return out


def _ssd_kernel_ms(ssd_args, kernel) -> dict:
    """`_kernel_ms` of the kernels the forward's route launches
    (ssd_state_pass, ssd_chunk_out, ssd_scan_kernel)."""
    from repro_torch.kernels.ssd_scan.ops import ssd

    return _kernel_ms(lambda: ssd(*ssd_args, kernel=kernel),
                      ("ssd_state_pass", "ssd_chunk_out", "ssd_scan_kernel"))


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


def _serve_once(model, params, ecfg, reqs, ctx, label, tag="serve"):
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
        say(f"[{tag}] {label} rid={r.rid} prompt={r.input_len} out={len(outs[r.rid])} "
            f"ttft={r.ttft():.4f}s tpot={r.mean_tpot():.5f}s e2e_ok={r.meets_e2e()} [{card}]")
    check(finite, f"{label}: a logit row was not finite")
    check(all(n > 0 for n in launches.values()), f"{label}: a kernel never launched: {launches}")
    say(f"[{tag}] {label}: {len(reqs)} requests in {wall:.3f} s; prefill chunks "
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
    # the main path's run, counts zeroed just before it
    ctx.setdefault("launches", {}).update(launches)
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
    _families_parity(ctx)


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
def _decode_loop(model, params, tok, pos, cache, steps, finite):
    """``steps`` greedy Model.decode steps, each ending in a sync; returns the
    tokens (B, steps), the step times and the cache."""
    import torch

    out, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode(params, tok[:, None], pos, cache)
        tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite.append(torch.isfinite(logits).all())
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, 1), step_s, cache


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
        out, step_s, cache = _decode_loop(model, params, torch.argmax(logits, -1), valid.clone(),
                                          cache, SSM_STEPS, finite)
        launched = {name: k.launches for name, k in kernels.items()}  # prefill and decode
        by_route = dict(ssd.route_launches)
        finite.append(torch.isfinite(cache["state"]).all())
        peak = torch.cuda.max_memory_allocated() / 2**30
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


# ------------------------------------------------------------------- families
class _AttnProbe:
    """While open, records the (head dim, query heads per KV head) of every
    call the model's attention makes to the two kernels' wrappers, and
    counts the calls that took a plain path (naive or blockwise) instead:
    on the card only a window that binds sends a call there. The launch
    counts stay the wrappers' own."""

    KERNELS = ("prefill_attention", "decode_attention")

    def __init__(self):
        from repro_torch.models import layers

        self._layers = layers
        self._saved = {n: getattr(layers, n) for n in
                       (*self.KERNELS, "naive_attention", "blockwise_attention")}
        self.shapes = {n: set() for n in self.KERNELS}
        self.plain = 0
        for name in self.KERNELS:
            setattr(layers, name, self._kernel(name, self._saved[name]))
        for name in ("naive_attention", "blockwise_attention"):
            setattr(layers, name, self._plain(self._saved[name]))

    def _kernel(self, name, fn):
        def wrapped(q, k, *args, **kw):
            self.shapes[name].add((int(q.shape[-1]), int(q.shape[-2]) // int(k.shape[2])))
            return fn(q, k, *args, **kw)
        return wrapped

    def _plain(self, fn):
        def wrapped(*args, **kw):
            self.plain += 1
            return fn(*args, **kw)
        return wrapped

    def close(self) -> None:
        for name, fn in self._saved.items():
            setattr(self._layers, name, fn)


# the families phase's serve: 8 requests of 64-3584 prompt tokens (order
# shuffled by the seed), 32 output tokens each, 50 ms apart, into decode lanes
# of 4096 positions (gemma2-9b's window: its plain cache, ROADMAP C6)
FAMILY_PROMPTS = (64, 256, 512, 1024, 1536, 2048, 3072, 3584)
FAMILY_MAX_LEN = 4096
# gemma2-9b through the model API: two prompts past the 4096-token window
# (its local layers' window binds), handed into the ring of an 8192-row cache
GEMMA_PROMPTS, GEMMA_RING_LEN, GEMMA_STEPS = (5120, 4400), 8192, 32
# chameleon-34b (vlm) through the model API: prefill from embeddings
VLM_BATCH, VLM_LEN, VLM_STEPS = 2, 1024, 16


def _family_model(ctx, arch, num_layers=None):
    """The config at full width (bf16, its own dtype), depth cut to
    ``num_layers`` where given, and random weights from seed 0."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    _free()
    cfg = get_config(arch)
    full = cfg.num_layers
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=ctx["device"])
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    extra = []
    if cfg.num_experts:
        extra.append(f"{cfg.num_experts} experts top-{cfg.experts_per_token}, capacity factor "
                     f"{cfg.capacity_factor}")
    if cfg.sliding_window:
        extra.append(f"window {cfg.sliding_window} on the even layers" if
                     cfg.alternate_local_global else f"window {cfg.sliding_window}")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        extra.append(f"softcaps attention {cfg.attn_logit_softcap} final "
                     f"{cfg.final_logit_softcap}")
    if cfg.use_qk_norm:
        extra.append("qk-norm")
    if cfg.input_mode != "tokens":
        extra.append(f"input {cfg.input_mode}")
    depth = f"depth cut {full} -> {cfg.num_layers}" if num_layers else f"all {full} layers"
    say(f"[families] {cfg.name} ({cfg.family}): {depth}, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {'; '.join(extra) + ', ' if extra else ''}{cfg.dtype}; "
        f"{n / 1e9:.3f} B random parameters ({2 * n / 1e9:.1f} GB, seed 0) in "
        f"{time.perf_counter() - t0:.1f} s [{ctx['card']}]")
    return cfg, model, params


def _family_serve(ctx, cfg, model, params, lens, page_sizes, max_slots, max_len):
    """ServeSession under kairos-urgency / kairos-slack at chunk 512, once per
    page size: every request done with 32 tokens, every logit row finite,
    both kernels launched (counted from zero) at the model's head dim and
    query heads per KV head, and no call on a plain windowed path."""
    from repro_torch.launch.smoke_workload import smoke_requests
    from repro_torch.serving.engine import EngineConfig

    want = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    for ps in page_sizes:
        ecfg = EngineConfig(max_slots=max_slots, max_len=max_len, chunk_size=512,
                            prefill_policy="kairos-urgency", decode_policy="kairos-slack",
                            eos_token=-1, page_size=ps)
        label = f"{cfg.name} {'paged (page_size=64)' if ps else 'slot'}"
        probe = _AttnProbe()
        try:
            _serve_once(model, params, ecfg, smoke_requests(cfg.vocab_size, lens=lens), ctx,
                        label, tag="families")
        finally:
            probe.close()
        check(probe.shapes == {n: {want} for n in probe.KERNELS},
              f"[families] {label}: kernel calls at (Dh, Hq/Hkv) {probe.shapes}, expected {want}")
        check(probe.plain == 0, f"[families] {label}: {probe.plain} calls took a plain "
              "windowed path (max_len <= window: none should)")
        say(f"[families] {label}: every attention call on the kernels at Dh={want[0]}, "
            f"Hq/Hkv={want[1]}; none on a plain path [{ctx['card']}]")
        _free()


def _gemma2_model_api(ctx, cfg, model, params) -> None:
    """Model.prefill of 2 right-padded prompts past the window (the local
    layers take the naive path, the global ones the prefill kernel), the
    handoff into the ring of init_cache(2, 8192), and 32 greedy decode steps
    whose every attention, ring included, runs on the decode kernel."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import handoff

    dev, card = ctx["device"], ctx["card"]
    rng = np.random.default_rng(1)
    toks = np.zeros((len(GEMMA_PROMPTS), max(GEMMA_PROMPTS)), np.int64)
    for i, n in enumerate(GEMMA_PROMPTS):
        toks[i, :n] = rng.integers(2, cfg.vocab_size, n)
    inputs = torch.tensor(toks, device=dev)
    valid = torch.tensor(GEMMA_PROMPTS, dtype=torch.int32, device=dev)
    n_loc = cfg.num_layers // 2
    _free()
    torch.cuda.reset_peak_memory_stats()
    probe = _AttnProbe()
    try:
        _attention_launches(zero=True)
        t0 = time.perf_counter()
        logits, kv = model.prefill(params, dict(inputs=inputs), valid_len=valid)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = _attention_launches()
        plain_prefill, probe.plain = probe.plain, 0
        cache = handoff(cfg, kv, model.init_cache(len(GEMMA_PROMPTS), GEMMA_RING_LEN, device=dev),
                        valid_len=valid)
        del kv
        check(tuple(cache["k_local"].shape[:3]) == (n_loc, len(GEMMA_PROMPTS), cfg.sliding_window)
              and cache["k"].shape[2] == GEMMA_RING_LEN,
              f"[families] gemma2 ring: cache leaves {[tuple(v.shape) for v in cache.values()]}")
        finite = [torch.isfinite(logits).all()]
        _attention_launches(zero=True)
        out, step_s, cache = _decode_loop(model, params, torch.argmax(logits, -1), valid.clone(),
                                          cache, GEMMA_STEPS, finite)
        dec = _attention_launches()
    finally:
        probe.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(bool(f) for f in finite), "[families] gemma2 model API: a logit row was not finite")
    check(plain_prefill == n_loc and pre == {"prefill_attention": cfg.num_layers - n_loc,
                                             "decode_attention": 0},
          f"[families] gemma2 prefill: {plain_prefill} plain calls (expected {n_loc}: the local "
          f"layers' window binds), launches {pre}")
    check(probe.plain == 0 and dec == {"prefill_attention": 0,
                                       "decode_attention": GEMMA_STEPS * cfg.num_layers},
          f"[families] gemma2 ring decode: {probe.plain} plain calls, launches {dec}, expected "
          f"{GEMMA_STEPS * cfg.num_layers} decode launches ({GEMMA_STEPS * n_loc} on the ring)")
    say(f"[families] {cfg.name} model API: prefill of {len(GEMMA_PROMPTS)} prompts "
        f"{list(GEMMA_PROMPTS)} (right-padded, valid_len) {1e3 * prefill_s:.2f} ms, {n_loc} local "
        f"layers on the naive path (window {cfg.sliding_window} binds), {pre['prefill_attention']} "
        f"prefill_attention launches; handoff into init_cache({len(GEMMA_PROMPTS)}, "
        f"{GEMMA_RING_LEN}) = ring of {cfg.sliding_window} rows for {n_loc} layers; "
        f"{GEMMA_STEPS} greedy decode steps mean {1e3 * sum(step_s) / len(step_s):.2f} ms (first "
        f"{1e3 * step_s[0]:.2f} ms); decode_attention launches {dec['decode_attention']}, "
        f"{GEMMA_STEPS * n_loc} of them on the ring; peak memory {peak:.2f} GiB; all logits "
        f"finite (softcaps {cfg.attn_logit_softcap}/{cfg.final_logit_softcap}); request 1's "
        f"first tokens {out[1, :8].tolist()} [{card}]")
    del cache, logits


def _vlm_model_api(ctx, cfg, model, params) -> None:
    """Model.prefill from seeded embeddings, the handoff, 16 greedy decode
    steps on tokens; both kernels at Hq/Hkv = 8."""
    import torch

    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import handoff

    dev, card = ctx["device"], ctx["card"]
    gen = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn((VLM_BATCH, VLM_LEN, cfg.d_model), generator=gen, device=dev)
    emb = emb.to(dtype_of(cfg.dtype))
    _free()
    torch.cuda.reset_peak_memory_stats()
    probe = _AttnProbe()
    try:
        _attention_launches(zero=True)
        t0 = time.perf_counter()
        logits, kv = model.prefill(params, dict(inputs=emb))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache = handoff(cfg, kv, model.init_cache(VLM_BATCH, VLM_LEN + VLM_STEPS, device=dev))
        del kv
        finite = [torch.isfinite(logits).all()]
        pos = torch.full((VLM_BATCH,), VLM_LEN, dtype=torch.int32, device=dev)
        out, step_s, cache = _decode_loop(model, params, torch.argmax(logits, -1), pos, cache,
                                          VLM_STEPS, finite)
        launches = _attention_launches()
    finally:
        probe.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads)
    check(all(bool(f) for f in finite), "[families] vlm model API: a logit row was not finite")
    check(launches == {"prefill_attention": cfg.num_layers,
                       "decode_attention": VLM_STEPS * cfg.num_layers}
          and probe.shapes == {n: {want} for n in probe.KERNELS} and probe.plain == 0,
          f"[families] vlm model API: launches {launches}, (Dh, Hq/Hkv) {probe.shapes}, "
          f"plain calls {probe.plain}")
    say(f"[families] {cfg.name} model API: prefill from embeddings {tuple(emb.shape)} "
        f"{1e3 * prefill_s:.2f} ms; handoff; {VLM_STEPS} greedy decode steps on tokens mean "
        f"{1e3 * sum(step_s) / len(step_s):.2f} ms; launches {launches} at Dh={want[0]}, "
        f"Hq/Hkv={want[1]}; peak memory {peak:.2f} GiB; all logits finite; first tokens "
        f"{out[0, :8].tolist()} [{card}]")
    del cache, logits


def phase_families(ctx) -> None:
    """The moe, vlm and alternating local/global families at full width in
    bf16 (random weights from seed 0): gemma2-9b (all 42 layers) and
    phi3.5-moe-42b-a6.6b (16 of 32 layers: all 32 take ~84 GB in bf16, more
    than the card holds) served slot and paged; gemma2-9b through the model
    API onto its ring cache; chameleon-34b (8 of 48 layers) from
    embeddings and through a 4-request serve on tokens."""
    cfg, model, params = _family_model(ctx, "gemma2-9b")
    _family_serve(ctx, cfg, model, params, FAMILY_PROMPTS, (None, 64), 8, FAMILY_MAX_LEN)
    _gemma2_model_api(ctx, cfg, model, params)
    del params
    cfg, model, params = _family_model(ctx, "phi3.5-moe-42b-a6.6b", 16)
    _family_serve(ctx, cfg, model, params, FAMILY_PROMPTS, (None, 64), 8, FAMILY_MAX_LEN)
    del params
    cfg, model, params = _family_model(ctx, "chameleon-34b", 8)
    _vlm_model_api(ctx, cfg, model, params)
    _family_serve(ctx, cfg, model, params, (64, 512, 1024, 1536), (None,), 4, 2048)
    del params
    _free()


def _families_parity(ctx) -> None:
    """float32 at full width, cut depth: gemma2-9b at 4 layers (local,
    global, local, global) and phi3.5-moe at 2, engine tokens slot and paged
    equal reference_generate's; gemma2's ring (a 4500-token prompt prefilled,
    handed into init_cache(1, 8192) and decoded 16 steps) gives the greedy
    tokens of the same prompt decoded on a plain 8192-row cache, whose local
    layers apply the window in the mask. phi3.5-moe runs at capacity factor
    8, where nothing is dropped: with drops the tokens depend on which rows
    share a dispatch group (a chunk's padding, batch-mates), in the
    reference as in the port, so an engine and reference_generate need not
    agree; the CPU tests hold the dropping regime against JAX."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import handoff
    from repro_torch.serving.engine import DisaggServer, EngineConfig, reference_generate

    dev, card = ctx["device"], ctx["card"]
    for arch, depth, extra in (("gemma2-9b", 4, {}),
                               ("phi3.5-moe-42b-a6.6b", 2, dict(capacity_factor=8.0))):
        _free()
        cfg = get_config(arch).replace(dtype="float32", num_layers=depth, **extra)
        model = build_model(cfg)
        params = model.init(seed=1, device=dev)
        rng = np.random.default_rng(1)
        prompts = [list(map(int, rng.integers(2, cfg.vocab_size, n))) for n in (17, 64, 130, 250)]
        max_len, n_new = 512, 8
        refs = [reference_generate(model, params, p, n_new, max_len, eos=-1) for p in prompts]
        for ps in (None, 64):
            ecfg = EngineConfig(max_slots=4, max_len=max_len, chunk_size=128, eos_token=-1,
                                page_size=ps)
            outs = DisaggServer(model, params, ecfg, device=dev).serve(
                _requests(prompts, n_new, 0.01, 60.0, 5.0))
            label = f"{arch} {'paged' if ps else 'slot'}"
            for i, ref in enumerate(refs):
                check(outs[i] == ref, f"parity {label}: rid {i} tokens {outs[i]} != {ref}")
            say(f"[parity] {label}: tokens of {len(prompts)} requests equal "
                f"reference_generate's ({cfg.dtype}, full width, depth cut "
                f"{get_config(arch).num_layers} -> {depth}{', capacity factor 8' if extra else ''})"
                f" [{card}]")
        if cfg.alternate_local_global:
            n = 4500
            prompt = torch.tensor(rng.integers(2, cfg.vocab_size, n), device=dev)[None]
            lg, kv = model.prefill(params, dict(inputs=prompt))
            ring = handoff(cfg, kv, model.init_cache(1, GEMMA_RING_LEN, device=dev))
            check("k_local" in ring, "parity gemma2: init_cache(1, 8192) is not the ring")
            shape = (cfg.num_layers, 1, GEMMA_RING_LEN, cfg.num_kv_heads, cfg.resolved_head_dim)
            plain = handoff(cfg, kv, dict(k=torch.zeros(shape, device=dev),
                                          v=torch.zeros(shape, device=dev)))
            del kv
            seqs, logs = [], []
            for cache in (ring, plain):
                tok, seq, lgs = torch.argmax(lg, -1), [], []
                for t in range(16):
                    seq.append(int(tok))
                    l, cache = model.decode(params, tok[:, None],
                                            torch.tensor([n + t], device=dev), cache)
                    lgs.append(l)
                    tok = torch.argmax(l, -1)
                seqs.append(seq)
                logs.append(torch.cat(lgs))
            err = _max_err(logs[0], logs[1])
            check(seqs[0] == seqs[1], f"parity gemma2 ring: tokens {seqs[0]} != plain cache "
                  f"under the window mask {seqs[1]}")
            say(f"[parity] gemma2-9b ring: a {n}-token prompt prefilled, handed into the ring "
                f"and decoded 16 steps gives the greedy tokens of the plain 8192-row cache under "
                f"the window mask; logits max abs err {err:.3e} [{card}]")
            del ring, plain
        del params
    _free()
    _moe_dropping_check(ctx)


MOE_CHUNK, MOE_SKEW = 512, 1.5  # tokens of one prefill chunk; logit added to expert 0
# the card's moe_ffn against the CPU's, token by token: ||out_t - cpu_t|| over
# the rms token norm. f32 rounding alone reads 3.2e-6 on an H100 (8.2e-7
# against f64 on the CPU at a quarter of phi3.5's width); one choice routed or
# dropped otherwise moves its token by the order of its whole norm.
MOE_CARD_REL = 1e-5


def _moe_dropping_check(ctx) -> None:
    """phi3.5-moe's expert layer at full width in f32 and the config's
    capacity factor 1.25, on a 512-token chunk skewed toward expert 0 (its
    router logit raised by MOE_SKEW) so that experts overflow their 80 slots:
    moe_ffn on the card equals the same call on CPU copies of the inputs
    (routing, cumsum slot positions, k-major drops and the stable top-k sort
    on CUDA against the CPU's), the expert choices are identical, choices
    were dropped, and the drops change the output (it is not the dense
    oracle's)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.moe import _route, init_moe_params, moe_ffn, moe_ffn_ref

    dev, card = ctx["device"], ctx["card"]
    _free()
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(2)
    params = init_moe_params(gen, cfg, torch.float32, dev)
    r0 = params["router"][:, 0]
    x = torch.randn((1, MOE_CHUNK, cfg.d_model), generator=gen, device=dev)
    x = x + MOE_SKEW * r0 / r0.dot(r0)
    t0 = time.perf_counter()
    out = moe_ffn(x, params, cfg)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    oracle = moe_ffn_ref(x, params, cfg)
    _, topi = _route(x.reshape(-1, cfg.d_model), params["router"], cfg.experts_per_token)
    cpu = {n: t.cpu() for n, t in params.items()}
    del params
    t0 = time.perf_counter()
    out_cpu = moe_ffn(x.cpu(), cpu, cfg)
    cpu_s = time.perf_counter() - t0
    _, topi_cpu = _route(x.cpu().reshape(-1, cfg.d_model), cpu["router"], cfg.experts_per_token)
    del cpu
    cap = cfg.moe_capacity(MOE_CHUNK)
    per_expert = torch.bincount(topi_cpu.flatten(), minlength=cfg.num_experts)
    dropped = int((per_expert - cap).clamp_min(0).sum())
    diff = (out.cpu() - out_cpu).reshape(MOE_CHUNK, -1).norm(dim=1)
    err = float(diff.max() / out_cpu.reshape(MOE_CHUNK, -1).norm(dim=1).pow(2).mean().sqrt())
    check(torch.equal(topi.cpu(), topi_cpu), "moe dropping: expert choices on the card differ "
          "from the CPU's")
    check(dropped > 0, f"moe dropping: no choice dropped (per expert {per_expert.tolist()}, "
          f"capacity {cap})")
    check(err <= MOE_CARD_REL, f"moe dropping: moe_ffn on the card against the CPU's, worst "
          f"token {err:.3e} of the rms token norm (limit {MOE_CARD_REL})")
    drop_err = _max_err(out, oracle)
    check(drop_err > 1e3 * MOE_CARD_REL * float(out.abs().max()),
          f"moe dropping: the drops do not change the output (max abs {drop_err:.3e} from the "
          f"dense oracle)")
    say(f"[parity] phi3.5-moe expert layer (full width: d_model {cfg.d_model}, {cfg.num_experts} "
        f"experts top-{cfg.experts_per_token}, d_ff {cfg.d_ff}; f32) on a {MOE_CHUNK}-token "
        f"chunk skewed toward expert 0, capacity factor {cfg.capacity_factor} = {cap} slots: "
        f"choices per expert {per_expert.tolist()}, {dropped} dropped; card equals CPU "
        f"(worst token {err:.3e} of the rms token norm, limit {MOE_CARD_REL}; expert choices "
        f"identical; card {1e3 * gpu_s:.1f} "
        f"ms, CPU {1e3 * cpu_s:.1f} ms); drops move the output {drop_err:.3e} from the dense "
        f"oracle [{card}]")
    _free()


# --------------------------------------------------------------------- encdec
# seamless-m4t-medium through the model API: 4 sources of DECODE_ENC_LEN
# seeded frame embeddings (the reference's decode-cell memory), target
# prefixes of 16 tokens with valid lengths 16/12/8/4, a 512-row self cache and
# 64 greedy decode steps
ENC_TGT, ENC_VALID, ENC_MAX_LEN, ENC_STEPS = 16, (16, 12, 8, 4), 512, 64
ENC_PARITY_LAYERS, ENC_PARITY_SRC = 4, 1024  # f32 parity: 4 + 4 layers, 1024 frames
ENC_PARITY_TOL = 2e-4  # atol = rtol, as tests/test_models_numerics.py


def phase_encdec(ctx) -> None:
    """seamless-m4t-medium at full width and depth (12 + 12 layers) in bf16,
    random weights from seed 0: Model.prefill (encoder and cross attention
    on the plain non-causal path, the decoder's self attention on the
    prefill kernel), the handoff into a 512-row self cache with the cross
    leaves at the encoder's length, 64 greedy Model.decode steps (self and
    cross attention on the decode kernel); then the f32 parity at full width,
    4 + 4 layers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.prefill_attention.ops import prefill_attention
    from repro_torch.models import build_model
    from repro_torch.models.encdec import DECODE_ENC_LEN, handoff

    dev, card = ctx["device"], ctx["card"]
    _free()
    cfg = get_config("seamless-m4t-medium")  # full width and depth, bf16 (its own dtype)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[encdec] {cfg.name}: {cfg.enc_layers} encoder + {cfg.num_layers} decoder layers, "
        f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.act}, "
        f"{cfg.dtype}; {n_params / 1e9:.3f} B random parameters (seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    b = len(ENC_VALID)
    gen = torch.Generator(device=dev).manual_seed(0)
    src = torch.randn((b, DECODE_ENC_LEN, cfg.d_model), generator=gen, device=dev)
    src = src.to(torch.bfloat16)
    rng = np.random.default_rng(0)
    tgt = torch.tensor(rng.integers(2, cfg.vocab_size, (b, ENC_TGT)), device=dev)
    valid = torch.tensor(ENC_VALID, dtype=torch.int32, device=dev)
    kernels = {"prefill_attention": prefill_attention, "decode_attention": decode_attention}

    def counts(zero=False):
        out = {n: k.launches for n, k in kernels.items()}
        if zero:
            for k in kernels.values():
                k.launches = 0
        return out

    probe = _AttnProbe()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts(zero=True)
        t0 = time.perf_counter()
        logits, kv = model.prefill(params, dict(src=src, tgt=tgt), valid_len=valid)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre, pre_plain = counts(zero=True), probe.plain
        prefill_peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"prefill_attention": cfg.num_layers, "decode_attention": 0}
        check(pre == want, f"[encdec] prefill launched {pre}, expected {want}")
        check(pre_plain == cfg.enc_layers + cfg.num_layers,
              f"[encdec] prefill made {pre_plain} calls on the plain non-causal path, expected "
              f"{cfg.enc_layers} (encoder) + {cfg.num_layers} (cross)")
        cache = handoff(cfg, kv, ENC_MAX_LEN)
        del kv
        check(tuple(cache["cross_k"].shape[2:]) == (DECODE_ENC_LEN, cfg.num_kv_heads,
                                                     cfg.resolved_head_dim)
              and cache["self_k"].shape[2] == ENC_MAX_LEN, "[encdec] handoff cache shapes "
              f"{ {n: tuple(t.shape) for n, t in cache.items()} }")
        probe.plain = 0
        finite = [torch.isfinite(logits).all()]
        out, step_s, cache = _decode_loop(model, params, torch.argmax(logits, -1), valid.clone(),
                                          cache, ENC_STEPS, finite)
        dec, dec_plain = counts(), probe.plain
        shapes = {n: sorted(v) for n, v in probe.shapes.items()}
    finally:
        probe.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"prefill_attention": 0, "decode_attention": 2 * cfg.num_layers * ENC_STEPS}
    check(dec == want, f"[encdec] {ENC_STEPS} decode steps launched {dec}, expected {want} "
          f"({2 * cfg.num_layers} decode kernels a step: self and cross)")
    check(dec_plain == 0, f"[encdec] decode made {dec_plain} calls on a plain path")
    check(all(bool(f) for f in finite), "[encdec] a logit row was not finite")
    check(tuple(out.shape) == (b, ENC_STEPS), f"[encdec] tokens {tuple(out.shape)}")
    check(shapes == {n: [(cfg.resolved_head_dim, 1)] for n in kernels},
          f"[encdec] kernel calls at (Dh, Hq/Hkv) {shapes}")
    say(f"[encdec] prefill of {b} sources x {DECODE_ENC_LEN} frames, target prefixes "
        f"{ENC_TGT} (valid {list(ENC_VALID)}) {1e3 * prefill_s:.2f} ms (peak "
        f"{prefill_peak:.2f} GiB); launches {pre}, {pre_plain} plain non-causal calls; "
        f"handoff into a {ENC_MAX_LEN}-row self cache, cross leaves at {DECODE_ENC_LEN} rows; "
        f"{ENC_STEPS} greedy decode steps mean {1e3 * sum(step_s) / len(step_s):.2f} ms (first "
        f"{1e3 * step_s[0]:.2f} ms); launches {dec} ({2 * cfg.num_layers} a step), 0 plain "
        f"calls; kernels at (Dh, Hq/Hkv) {shapes['decode_attention'][0]}; peak memory "
        f"{peak:.2f} GiB; all logits finite; request 0's first tokens {out[0, :8].tolist()} "
        f"[{card}]")
    del params, cache, logits
    _encdec_parity(ctx)


def _encdec_parity(ctx) -> None:
    """float32 at full width, 4 encoder + 4 decoder layers: the prefill of a
    16-token target prefix then 16 teacher-forced decode steps give the last
    logits of the prefill of the 32-token prefix, and the 8 greedy tokens
    after both paths are equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.encdec import handoff

    dev, card = ctx["device"], ctx["card"]
    _free()
    cfg = get_config("seamless-m4t-medium").replace(
        dtype="float32", num_layers=ENC_PARITY_LAYERS, enc_layers=ENC_PARITY_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    src = torch.randn((2, ENC_PARITY_SRC, cfg.d_model), generator=gen, device=dev)
    tgt = torch.tensor(np.random.default_rng(1).integers(2, cfg.vocab_size, (2, 32)), device=dev)
    max_len, n = 64, 16
    lg_a, kv = model.prefill(params, dict(src=src, tgt=tgt[:, :n]))
    cache_a = handoff(cfg, kv, max_len)
    for t in range(n, 2 * n):
        lg_a, cache_a = model.decode(params, tgt[:, t:t + 1], torch.full((2,), t, device=dev),
                                     cache_a)
    lg_b, kv = model.prefill(params, dict(src=src, tgt=tgt))
    cache_b = handoff(cfg, kv, max_len)
    del kv
    err = _max_err(lg_a, lg_b)
    check(bool(torch.allclose(lg_a, lg_b, rtol=ENC_PARITY_TOL, atol=ENC_PARITY_TOL)),
          f"[parity] seamless f32: prefill + {n} decode steps vs prefill of {2 * n} tokens, "
          f"logits max abs err {err:.3e} beyond {ENC_PARITY_TOL}")
    seqs = []
    for lg, cache in ((lg_a, cache_a), (lg_b, cache_b)):
        tok, seq = torch.argmax(lg, -1), []
        for t in range(8):
            seq.append(tok.tolist())
            lg, cache = model.decode(params, tok[:, None], torch.full((2,), 2 * n + t, device=dev),
                                     cache)
            tok = torch.argmax(lg, -1)
        seqs.append(seq)
    check(seqs[0] == seqs[1], f"[parity] seamless f32: greedy tokens {seqs[0]} != {seqs[1]}")
    say(f"[parity] seamless-m4t-medium f32, full width, depth cut {get_config(cfg.name).enc_layers}"
        f" + {get_config(cfg.name).num_layers} -> {ENC_PARITY_LAYERS} + {ENC_PARITY_LAYERS}, "
        f"{ENC_PARITY_SRC} frames: prefill of {n} target tokens + {n} decode steps vs prefill "
        f"of {2 * n}, last logits max abs err {err:.3e} (tol {ENC_PARITY_TOL}); 8 greedy tokens "
        f"after each path equal [{card}]")
    del params, cache_a, cache_b
    _free()


# ---------------------------------------------------------------------- sched
SCHED_SIZES = (256, 4096)  # kernel_bench's queue, and a queue of thousands of slots
SCHED_REPS = 20


def _sched_queues(n: int):
    """kernel_bench's queues (benchmarks/kernel_bench.py:84-130) at n slots,
    from seed 0: n queued prefill requests (arrivals in [0, 10) s, prompts
    of 100-100,000 tokens) and n decoding requests (sequences of
    1,000-131,072 tokens, 1-100 tokens decoded since t = 9 s)."""
    import numpy as np

    from repro_torch.core.request import Phase, Request, SLOSpec

    rng = np.random.default_rng(0)
    queue = [Request(rid=i, arrival=float(rng.uniform(0, 10)),
                     input_len=int(rng.integers(100, 100_000)), output_len=200, slo=SLOSpec())
             for i in range(n)]
    active = []
    for i in range(n):
        r = Request(rid=i, arrival=0.0, input_len=int(rng.integers(1000, 131_072)),
                    output_len=500, slo=SLOSpec())
        r.first_token_time = r.decode_start = 9.0
        r.n_generated = r.n_decoded = int(rng.integers(1, 100))
        r.phase = Phase.DECODE
        active.append(r)
    return queue, active


def _host_ms(fn, reps: int) -> float:
    """Mean time per call of a host policy's decision, on the host's clock."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_sched(ctx) -> None:
    """The Kairos schedulers as device programs (core/device_sched.py) on the
    card at n = 256 and 4096 slots, held against the port's host policies
    with the property tests' criteria (urgency: totals within a token, takes
    equal where no score ties; slack: batch size within one, the fallback
    exact), the sched_scan kernels bit for bit against their plain versions,
    and each decision timed beside the host policy's."""
    import numpy as np
    import torch

    from repro_torch.core import device_sched as ds
    from repro_torch.core.lut import StepTimeLUT
    from repro_torch.kernels.sched_scan.ops import fcfs_scan, slack_pack
    from repro_torch.kernels.sched_scan.ref import fcfs_scan_ref, slack_pack_ref
    from repro_torch.policies import SlackDecodeScheduler, UrgencyPrefillScheduler
    from repro_torch.sim.costmodel import PAPER_COST_MODEL

    dev, card = ctx["device"], ctx["card"]
    t_now, mu, budget = 5.0, 20_000.0, 8192
    lut = StepTimeLUT(analytic=PAPER_COST_MODEL.decode_lut_seed)
    tab, be, se = ds.lut_tensors(lut, dev)
    fcfs_scan.launches = slack_pack.launches = 0  # the main path: the decisions below
    scan_args = {}
    for n in SCHED_SIZES:
        queue, active = _sched_queues(n)
        host = UrgencyPrefillScheduler()
        host_take = np.zeros(n)
        for r, take in host.select(queue, t_now, mu, budget):
            host_take[r.rid] = take
        slots = ds.prefill_slots(queue, device=dev)
        urg = lambda: ds.urgency_select(  # noqa: E731
            slots["arrivals"], slots["input_lens"], slots["remaining"], slots["active"], t_now,
            mu, slots["slo_ttft"], budget)
        take = urg().cpu().numpy()
        u = host.urgency_scores(queue, t_now, mu)
        untied = len(set(np.round(u * 1e7).astype(np.int64))) == n
        compared = "totals and takes (no tied score)" if untied else "totals (scores tie)"
        check(abs(take.sum() - host_take.sum()) <= 1.0,
              f"[sched] n={n}: urgency totals {take.sum()} vs host {host_take.sum()}")
        if untied:
            check(np.abs(take - host_take).max() <= 1.0,
                  f"[sched] n={n}: urgency takes differ from the host's on untied scores")
        dev_ms = _time_ms(urg, iters=SCHED_REPS, flush=lambda: None)
        host_ms = _host_ms(lambda: host.select(queue, t_now, mu, budget), SCHED_REPS)
        say(f"[sched] n={n} urgency_select: device {dev_ms:.4f} ms per decision (CUDA events, "
            f"ends in a sync), host UrgencyPrefillScheduler.select {host_ms:.4f} ms; "
            f"{int((take > 0).sum())} slots take {take.sum():.0f} of {budget} tokens; the host's "
            f"{compared} equal [{card}]")
        dslots = ds.decode_slots(active, device=dev)
        sels = {}
        for t_dec in (10.0, 9.0):  # kernel_bench's (nothing packs: decode all), and t = 9 s
            dsel = lambda: ds.slack_select(  # noqa: E731
                dslots["seq_lens"], dslots["n_gen"], dslots["first_token_t"], dslots["active"],
                t_dec, dslots["slo_tpot"], tab, be, se)
            sel = dsel()
            sels[t_dec] = sel
            got = sel.selected.cpu().numpy()
            hsched = SlackDecodeScheduler(lut, slo_margin=1.0)
            batch, _ = hsched.select(active, t_dec)
            want = np.zeros(n, bool)
            want[[r.rid for r in batch]] = True
            if want.all():
                check(got.all(), f"[sched] n={n} t={t_dec}: host decodes all, device "
                      f"{int(got.sum())}")
            else:
                check(abs(int(got.sum()) - int(want.sum())) <= 1,
                      f"[sched] n={n} t={t_dec}: batch {int(got.sum())} vs host {int(want.sum())}")
            check(int(sel.batch_size) == int(got.sum()), f"[sched] n={n}: batch_size "
                  f"{int(sel.batch_size)} != {int(got.sum())} selected")
            dev_ms = _time_ms(dsel, iters=SCHED_REPS, flush=lambda: None)
            host_ms = _host_ms(lambda: hsched.select(active, t_dec), SCHED_REPS)
            say(f"[sched] n={n} slack_select at t={t_dec}: device {dev_ms:.4f} ms per decision, "
                f"host SlackDecodeScheduler.select {host_ms:.4f} ms; batch {int(got.sum())} "
                f"(host {int(want.sum())}{', all: the fallback' if want.all() else ''}), s_min "
                f"{float(sel.s_min):.5f} s [{card}]")
        if n == max(SCHED_SIZES):  # the scans' inputs at the largest queue
            order = torch.argsort(torch.where(slots["active"], slots["arrivals"], 3.0e38),
                                  stable=True)
            d = torch.where(slots["active"], slots["remaining"] / torch.tensor(mu, device=dev),
                            0.0)
            scan_args["fcfs"] = (slots["arrivals"][order].contiguous(), d[order].contiguous(),
                                 torch.tensor([t_now], device=dev))
            order = torch.argsort(dslots["seq_lens"], stable=True)
            scan_args["pack"] = (dslots["seq_lens"][order].contiguous(),
                                 dslots["active"][order].contiguous(),
                                 sels[9.0].s_min.reshape(1), tab, be, se)
    launches = fcfs_scan.launches + slack_pack.launches
    check(fcfs_scan.launches > 0 and slack_pack.launches > 0,
          f"[sched] fcfs_scan launched {fcfs_scan.launches}, slack_pack {slack_pack.launches}")
    ctx["launches"]["sched_scan"] = launches

    # sched_scan against its plain version, and its row of the kernel table
    fin, fin_ref = fcfs_scan(*scan_args["fcfs"]), fcfs_scan_ref(*scan_args["fcfs"])
    sel_s, cnt = slack_pack(*scan_args["pack"])
    sel_r, cnt_r = slack_pack_ref(*scan_args["pack"])
    err = _max_err(fin, fin_ref)
    check(torch.equal(fin, fin_ref), f"[sched] fcfs_scan differs from its plain version by {err}")
    check(torch.equal(sel_s, sel_r) and torch.equal(cnt, cnt_r),
          f"[sched] slack_pack selects {int(cnt)} slots, its plain version {int(cnt_r)}")
    n = max(SCHED_SIZES)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def both():
        fcfs_scan(*scan_args["fcfs"])
        slack_pack(*scan_args["pack"])

    def both_ref():
        fcfs_scan_ref(*scan_args["fcfs"])
        slack_pack_ref(*scan_args["pack"])

    nbytes = 4 * 3 * n + 4 + (4 + 1 + 1) * n + 4 * tab.numel() + 4 * (be.numel() + se.numel()) + 8
    row = dict(
        name="sched_scan", route="cuda", source="src/repro_torch/kernels/csrc/sched_scan.cu",
        replaces="src/repro/core/jax_sched.py:44", max_abs_err=err,
        ms=_time_ms(both, iters=20, flush=flush_buf.zero_),
        device_ms=_time_ms(both, iters=20, flush=flush_buf.zero_, device_only=True),
        plain_ms=_time_ms(both_ref, iters=2, flush=flush_buf.zero_),
        library_ms=None, **_bound(6 * n, nbytes, "torch.float32"),
        shape=f"N={n} slots, LUT {tuple(tab.shape)}",
    )
    say(f"[sched] sched_scan (fcfs_scan + slack_pack, one block each) at n={n}: kernels "
        f"{row['ms']:.4f} ms per pair of calls (device alone {row['device_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}; the "
        f"walk is a chain of dependent steps, which the bound does not see); bit for bit equal "
        f"to the plain versions (pack selects {int(cnt)}); launches on the main path "
        f"{launches} [{card}]")
    ctx["kernel_rows"].append(row)


# ---------------------------------------------------------------------- train
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 6, 2048, 8, 2
# The models trained whole, each with its learning rate, picked by a sweep of
# `_train_full` on an H100 (PERF.md §6). minicpm-2b: at 3e-5 to 3e-4 five
# updates move the loss less than its spread from batch to batch (~0.02), at
# 1e-3 and above the loss spikes by the sixth step; 6e-4 learns without a spike.
# zamba2-2.7b: of 3e-4, 6e-4, 1e-3 and 2e-3, six updates lower the first
# batch's loss most at 3e-4 (10.888 -> 10.453; 10.591, 10.761, 11.113), and
# from 1e-3 up the loss spikes within the six steps.
TRAIN_RUNS = (("minicpm-2b", 6e-4), ("zamba2-2.7b", 3e-4))
TRAIN_PEAK_LIMIT = 72e9  # bytes of device memory; above it the global batch is halved
TRAIN_LOSS_TOL, TRAIN_GRAD_REL = 2e-5, 1e-4  # card against CPU, f32, as the CPU tests
PEAK_SOURCE = "989 TFLOP/s dense bf16, NVIDIA H100 SXM data sheet"


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _flat_tree(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _train_kernels() -> dict:
    from repro_torch.kernels.prefill_attention.ops import prefill_attention, prefill_attention_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_bwd

    return dict(prefill_fwd=prefill_attention, prefill_bwd=prefill_attention_bwd, ssd_fwd=ssd,
                ssd_bwd=ssd_bwd)


def _train_launches() -> dict:
    """Launches of the kernels training runs, by kernel, since the last zero."""
    return {name: fn.launches for name, fn in _train_kernels().items()}


def _zero_train_launches():
    for fn in _train_kernels().values():
        fn.launches = 0


def _train_launches_per_step(cfg, n_micro: int) -> dict:
    """The kernel launches one train step must make: per microbatch each
    attention layer (once per use of zamba2's shared block) and each Mamba2
    layer launch their forward twice (remat) and their backward once."""
    attn = ssm = 0
    if cfg.family == "ssm":
        ssm = cfg.num_layers
    elif cfg.family == "hybrid":
        ssm, attn = cfg.num_layers, cfg.num_layers // cfg.hybrid_period
    else:
        attn = cfg.num_layers
    return dict(prefill_fwd=2 * attn * n_micro, prefill_bwd=attn * n_micro,
                ssd_fwd=2 * ssm * n_micro, ssd_bwd=ssm * n_micro)


def _train_parity(ctx) -> None:
    """llama3-8b-smoke, minicpm-2b-smoke, mamba2-130m-smoke and
    zamba2-2.7b-smoke in f32: the loss and gradients of one train step at 1
    and 2 microbatches on the card (the kernels: prefill attention and the
    SSD scan, forward and backward) against the CPU (the plain versions),
    from the same parameters and batch, and the parameters after the AdamW
    update; each kernel of the model's path must have launched as often as
    a step needs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state
    from repro_torch.training.train_step import loss_and_grad_accum

    for arch in ("llama3-8b-smoke", "minicpm-2b-smoke", "mamba2-130m-smoke", "zamba2-2.7b-smoke"):
        cfg = get_config(arch).replace(dtype="float32")
        model = build_model(cfg)
        batch = SyntheticDataset(cfg, DataConfig(seq_len=64, global_batch=4)).batch_at(0)
        for n_micro in (1, 2):
            runs = {}
            for dev in ("cpu", ctx["device"]):
                params = _tree_to(model.init(0, device="cpu"), dev)
                tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                _zero_train_launches()
                loss, grads = loss_and_grad_accum(model, params, tb, n_micro)
                launched = _train_launches()
                params, _, _ = adamw_update(OptimizerConfig(), params, grads,
                                            init_opt_state(params))
                runs[dev] = (float(loss), _tree_to(grads, "cpu"), _tree_to(params, "cpu"),
                             launched)
            (lc, gc, pc, _), (lg, gg, pg, launched) = runs["cpu"], runs[ctx["device"]]
            # one loss_and_grad_accum: the launches of a step
            want = _train_launches_per_step(cfg, n_micro)
            check(launched == want, f"[train] {arch} n_micro={n_micro}: kernel launches on the "
                  f"card {launched}, expected {want}")
            check(abs(lc - lg) <= TRAIN_LOSS_TOL, f"[train] {arch} n_micro={n_micro}: loss on "
                  f"the card {lg} against the CPU's {lc}")
            gcf, ggf = _flat_tree(gc), _flat_tree(gg)
            rel = {k: float((ggf[k].float() - g.float()).norm() / max(float(g.float().norm()),
                                                                       1e-6))
                   for k, g in gcf.items()}
            worst = max(rel, key=rel.get)
            check(rel[worst] <= TRAIN_GRAD_REL, f"[train] {arch} n_micro={n_micro}: grad "
                  f"{worst} relative error {rel[worst]:.3e} beyond {TRAIN_GRAD_REL}")
            perr = max(_max_err(_flat_tree(pg)[k], p) for k, p in _flat_tree(pc).items())
            check(perr <= 2e-4, f"[train] {arch} n_micro={n_micro}: params after the step "
                  f"differ by {perr:.3e}")
            say(f"[train] parity {arch} f32 n_micro={n_micro}: loss card {lg:.6f} cpu {lc:.6f} "
                f"(tol {TRAIN_LOSS_TOL}); worst grad leaf {worst} relative error "
                f"{rel[worst]:.3e} (limit {TRAIN_GRAD_REL}); params after AdamW max abs diff "
                f"{perr:.3e}; kernel launches on the card {launched} [{ctx['card']}]")


def _train_resume(ctx) -> None:
    """At smoke size on the card (llama3-8b-smoke, f32, 2 microbatches):
    three steps, a checkpoint, a restore into fresh tensors and a fourth
    step give the parameters and moments of four uninterrupted steps, bit
    for bit."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    model = build_model(cfg)
    ds = SyntheticDataset(cfg, DataConfig(seq_len=64, global_batch=4))
    step_fn = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=2, stable_steps=10,
                                                     decay_steps=2), n_micro=2)

    def run(params, opt, steps):
        for i in steps:
            batch = {k: torch.from_numpy(v).to(ctx["device"]) for k, v in ds.batch_at(i).items()}
            params, opt, _ = step_fn(params, opt, batch)
        return params, opt

    pa = model.init(0, device=ctx["device"])
    pa, oa = run(pa, init_opt_state(pa), range(4))
    pb = model.init(0, device=ctx["device"])
    pb, ob = run(pb, init_opt_state(pb), range(3))
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(3, {"params": pb, "opt": ob}, async_=True)
        ck.join()
        fresh = model.init(1, device=ctx["device"])
        restored, step = ck.restore({"params": fresh, "opt": init_opt_state(fresh)})
    pr, orr = run(restored["params"], restored["opt"], range(step, 4))
    check(step == 3 and int(orr.step) == int(oa.step) == 4, f"[train] resume: step {step}")
    for name, tree_a, tree_r in (("params", pa, pr), ("m", oa.m, orr.m), ("v", oa.v, orr.v)):
        fa, fr = _flat_tree(tree_a), _flat_tree(tree_r)
        bad = [k for k in fa if not torch.equal(fa[k], fr[k])]
        check(not bad, f"[train] resume: {name} leaves {bad} differ from the uninterrupted run")
    say(f"[train] resume {cfg.name} f32: 3 steps, checkpoint (async save, restore into fresh "
        f"tensors), 1 step: params, m and v bit-identical to 4 uninterrupted steps "
        f"[{ctx['card']}]")


def _train_flops(cfg, params, tokens: int) -> float:
    """Model FLOPs of one step at ``tokens`` tokens of TRAIN_SEQ, forward and
    backward, no recompute counted: 6 N per token, N counting zamba2's
    shared block once per use (count_params counts it once); causal
    attention's 6 L H Dh S per token, L the attention layers (the shared
    block's uses); and for the Mamba2 layers three times the SSD scan's
    forward operations (`_ssd_work`: the forward once, the backward twice)."""
    n = cfg.count_params()
    attn = ssm = 0
    if cfg.family == "hybrid":
        attn, ssm = cfg.num_layers // cfg.hybrid_period, cfg.num_layers
        n += (attn - 1) * sum(t.numel() for t in _leaves(params["shared_attn"]))
    elif cfg.family == "ssm":
        ssm = cfg.num_layers
    else:
        attn = cfg.num_layers
    flops = tokens * (6 * n + 6 * attn * cfg.num_heads * cfg.resolved_head_dim * TRAIN_SEQ)
    if ssm:
        scan, _ = _ssd_work(tokens // TRAIN_SEQ, TRAIN_SEQ, cfg.ssm_num_heads, cfg.ssm_head_dim,
                            cfg.ssm_state_dim, cfg.ssm_chunk, 2)
        flops += 3 * ssm * scan
    return flops


def _train_full(ctx, arch: str, lr: float, global_batch: int) -> dict:
    """``arch`` whole in bf16 (random weights from seed 0): TRAIN_STEPS AdamW
    steps at ``global_batch`` x TRAIN_SEQ tokens, TRAIN_MICRO microbatches,
    remat, WSD warm-up 2 to ``lr``; each step's kernel launches must be
    exactly `_train_launches_per_step`'s. Returns the run's readings."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step

    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=ctx["device"])
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    trunk = (f"{cfg.num_layers} Mamba2 layers ({cfg.ssm_num_heads} SSD heads x "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state_dim}, chunk {cfg.ssm_chunk})"
             if cfg.family in ("ssm", "hybrid") else f"{cfg.num_layers} layers")
    if cfg.family == "hybrid":
        trunk += (f", a shared attention block after every {cfg.hybrid_period} "
                  f"({cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim})")
    elif cfg.family != "ssm":
        trunk += f", heads {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim}"
    say(f"[train] {cfg.name}: {trunk}, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {n_params / 1e9:.4f} B random parameters (seed 0; "
        f"count_params {cfg.count_params() / 1e9:.4f} B) and AdamW state in "
        f"{time.perf_counter() - t0:.1f} s")
    ds = SyntheticDataset(cfg, DataConfig(seq_len=TRAIN_SEQ, global_batch=global_batch))
    step_fn = make_train_step(model, OptimizerConfig(lr=lr, warmup_steps=2,
                                                     stable_steps=TRAIN_STEPS, decay_steps=1),
                              n_micro=TRAIN_MICRO)
    tokens = global_batch * TRAIN_SEQ
    flops = _train_flops(cfg, params, tokens)
    want = _train_launches_per_step(cfg, TRAIN_MICRO)
    torch.cuda.reset_peak_memory_stats()
    _zero_train_launches()
    losses, out = [], dict(step_s=[], peak=[], gnorm=[])
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(ctx["device"]) for k, v in ds.batch_at(i).items()}
        before = _train_launches()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        launched = {k: v - before[k] for k, v in _train_launches().items()}
        loss, gnorm, lr_i = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        peak = torch.cuda.max_memory_allocated()
        losses.append(loss)
        out["step_s"].append(dt)
        out["peak"].append(peak)
        out["gnorm"].append(gnorm)
        say(f"[train] {cfg.name} step {i}: loss {loss:.4f} grad_norm {gnorm:.4f} lr {lr_i:.3e}; "
            f"{dt:.3f} s, {tokens / dt:.0f} tokens/s, model FLOPs {flops / dt / 1e12:.1f} "
            f"TFLOP/s = {flops / dt / 989e12:.4f} of the peak ({PEAK_SOURCE}); kernel launches "
            f"{launched}; peak memory {peak / 1e9:.2f} GB [{ctx['card']}]")
        check(all(map(math.isfinite, (loss, gnorm))), f"[train] {cfg.name} step {i}: loss "
              f"{loss}, grad norm {gnorm}")
        check(launched == want, f"[train] {cfg.name} step {i}: kernel launches {launched}, "
              f"expected {want} (remat runs each forward twice)")
        if i == 0 and peak > TRAIN_PEAK_LIMIT:
            break
    out.update(losses=losses, launches=_train_launches(), tokens=tokens, flops=flops, lr=lr,
               want=want)
    del m
    if len(losses) == TRAIN_STEPS:  # the first batch again, after training (batch-free signal)
        first = {k: torch.from_numpy(v).to(ctx["device"]) for k, v in ds.batch_at(0).items()}
        with torch.no_grad():
            out["first_after"] = sum(
                float(model.loss(params, {k: v.chunk(TRAIN_MICRO)[i] for k, v in first.items()}))
                for i in range(TRAIN_MICRO)) / TRAIN_MICRO
        out["profile"] = _train_profile(step_fn, params, opt, ds, ctx["device"])
    del params, opt
    return out


def _train_profile(step_fn, params, opt, ds, device) -> dict:
    """One more step (the next batch) under torch.profiler: the step's wall,
    the device's busy time and its kernels' time by group
    (`launch.profile.kernel_group`). The profiler's cost stretches the
    wall, so the idle share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import device_kernels, kernel_group

    batch = {k: torch.from_numpy(v).to(device) for k, v in ds.batch_at(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    names: dict = {}
    for name, k0, k1 in device_kernels(prof.events()):
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + (k1 - k0) / 1e3
        names[name] = names.get(name, 0.0) + (k1 - k0) / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])
    bwd = [kv for kv in top if kernel_group(kv[0]) in ("prefill_attention_bwd", "ssd_scan_bwd")]
    return dict(wall_ms=1e3 * wall, busy_ms=sum(groups.values()), groups=groups, top=top[:8],
                bwd=bwd)


def phase_train(ctx) -> None:
    """Training on the card: card-vs-CPU parity at smoke size, a
    bit-identical resume from a checkpoint, then minicpm-2b and zamba2-2.7b
    whole."""
    _free()
    _train_parity(ctx)
    _train_resume(ctx)
    for arch, lr in TRAIN_RUNS:
        _train_run(ctx, arch, lr)


def _train_run(ctx, arch: str, lr: float) -> None:
    """One model trained whole (`_train_full`, the global batch halved if the
    first step's peak passes TRAIN_PEAK_LIMIT): every loss falls in the sense
    the checks ask, and the run's readings are printed."""
    import torch

    _free()
    gb = TRAIN_BATCH
    r = _train_full(ctx, arch, lr, gb)
    if len(r["losses"]) < TRAIN_STEPS:
        say(f"[train] {arch}: peak memory {r['peak'][0] / 1e9:.2f} GB after the first step at "
            f"global batch {gb}, above {TRAIN_PEAK_LIMIT / 1e9:.0f} GB: the global batch is "
            f"halved")
        _free()
        gb //= 2
        r = _train_full(ctx, arch, lr, gb)
    _free()
    losses = r["losses"]
    check(losses[-1] < losses[0], f"[train] {arch}: the loss did not fall: {losses}")
    check(r["first_after"] < losses[0], f"[train] {arch}: the first batch's loss rose from "
          f"{losses[0]} to {r['first_after']} over {TRAIN_STEPS} steps")
    steady = r["step_s"][1:]
    mean = sum(steady) / len(steady)
    launches = ctx.setdefault("launches", {})
    if arch == "minicpm-2b":
        launches["prefill_attention_bwd"] = r["launches"]["prefill_bwd"]
    else:
        launches["ssd_scan_bwd"] = r["launches"]["ssd_bwd"]
    say(f"[train] {arch} whole, bf16, global batch {gb} x {TRAIN_SEQ} tokens, "
        f"{TRAIN_MICRO} microbatches, remat, lr {lr}: {TRAIN_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (the first batch's {losses[0]:.4f} -> "
        f"{r['first_after']:.4f} after training); grad norms "
        f"{', '.join(f'{g:.4f}' for g in r['gnorm'])}; steps 1-{TRAIN_STEPS - 1} mean "
        f"{mean:.3f} s, {r['tokens'] / mean:.0f} tokens/s, model FLOPs {r['flops']:.4e} a step "
        f"(`_train_flops`), share {r['flops'] / mean / 989e12:.4f} of the peak ({PEAK_SOURCE}); "
        f"first step {r['step_s'][0]:.3f} s; peak memory {max(r['peak']) / 1e9:.2f} GB "
        f"({torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB on the card); kernel "
        f"launches over the {TRAIN_STEPS} steps {r['launches']} ({r['want']} a step) "
        f"[{ctx['card']}]")
    pr = r["profile"]
    say(f"[train] {arch}: one more step under torch.profiler: wall {pr['wall_ms']:.1f} ms, "
        f"device busy {pr['busy_ms']:.1f} ms (idle "
        f"{100 * (1 - pr['busy_ms'] / pr['wall_ms']):.1f}% of the profiled wall, an upper "
        f"bound); by kernel group: " + ", ".join(
            f"{g} {ms:.1f} ms ({100 * ms / pr['busy_ms']:.1f}%)"
            for g, ms in sorted(pr["groups"].items(), key=lambda kv: -kv[1]))
        + f" [{ctx['card']}]")
    say(f"[train] {arch}: top kernels of the profiled step: " + "; ".join(
        f"{name[:70]} {ms:.1f} ms" for name, ms in pr["top"]))
    say(f"[train] {arch}: backward kernels of the profiled step: " + "; ".join(
        f"{name[:70]} {ms:.1f} ms" for name, ms in pr["bwd"]))


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
        for phase in (phase_device, phase_build, phase_kernels, phase_train, phase_serve,
                      phase_fleet, phase_eval, phase_parity, phase_ssm, phase_families,
                      phase_encdec, phase_sched):
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
        # attention: the slot serve; prefill_attention_bwd: the minicpm-2b training run;
        # ssd_scan: the zamba2 prefill; ssd_scan_bwd: the zamba2-2.7b training run;
        # sched_scan: the sched phase's decisions; counts zeroed before each
        r["launches"] = ctx["launches"][r["name"]]
    say(json.dumps({"kernels": rows}))
    say(f"card: {ctx['card']}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
