"""The port's roofline and cost model against the JAX package's, and its op
counter.

- ``RooflineTerms`` on the reference's inputs, with a ``ChipSpec`` built
  here from the reference's v5e numbers, equals the reference's
  ``as_dict()`` exactly; ``model_flops_for`` and ``analytic_memory_bytes``
  equal the reference's over ``ASSIGNED x ALL_SHAPES`` within rel 1e-12;
  ``ChipCostModel`` with that spec equals ``TPUCostModel(cfg).
  to_calibrated()`` field by field.
- ``op_stats`` counts a chain of 7 matmuls of 256 x 256 at exactly
  2 n^3 7 FLOPs (the reference's ``test_hlo_stats_scan_flops_exact``);
  bytes by the reference's rules (views free, gathers and scatters by their
  small operands); a kernel wrapper by its ``work()`` and none of its plain
  version's ops; a smoke prefill, decode and train step count the same on
  CPU and meta tensors (exactly; data at the canonical layout, and a ragged
  decode counts less on the CPU).
- The kernels' ``work()`` through ``analysis.bound`` gives the bounds PERF.md
  records for the kernel table (4 decimals of a ms, as printed), and the
  report over the smoke archs prints 40 rows, 8 skipped.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline.hw import V5E  # noqa: E402
from repro.sim.costmodel import TPUCostModel  # noqa: E402
from repro_torch.configs import ALL_SHAPES, ASSIGNED, get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.prefill_attention import ops as pops  # noqa: E402
from repro_torch.kernels.sched_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sdops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.roofline import analysis, hw, op_stats, report  # noqa: E402
from repro_torch.sim.costmodel import ChipCostModel  # noqa: E402

REL = 1e-12
BF16, F32 = torch.bfloat16, torch.float32
# the reference's v5e numbers, built here: the port holds no TPU constant
# (peak_flops_f32, which the reference lacks, is read by neither the terms
# nor the cost model)
V5E_SPEC = hw.ChipSpec(**dataclasses.asdict(V5E), peak_flops_f32=0.0)


# ------------------------------------------------------------ hardware, bound

def test_h100_is_the_data_sheet_s_and_the_port_has_no_tpu_entry():
    h = hw.H100
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_bw, h.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 80e9)
    assert h.ici_link_bw * h.ici_links == 900e9 and h.ici_links == 18
    assert "https://www.nvidia.com/en-us/data-center/h100/" in hw.__doc__
    assert not hasattr(hw, "V5E")


def test_bound_takes_the_larger_term_at_the_dtype_s_peak():
    assert analysis.bound(989e12, 0, BF16) == (1000.0, "operations")
    assert analysis.bound(67e12, 0, F32) == (1000.0, "operations")
    assert analysis.bound(1.0, 3.35e12, F32) == (1000.0, "bytes")
    assert analysis.bound(0, 0, BF16) == (0.0, "operations")


def _prefill_at_end(b, sq, skv, hq, hkv, dh, kv_lens=None):
    q_pos = (torch.arange(sq, dtype=torch.int32) + (skv - sq))[None].expand(b, sq)
    kv_len = torch.full((b,), skv, dtype=torch.int32) if kv_lens is None else torch.tensor(
        kv_lens, dtype=torch.int32)
    return pops.work(b, sq, hq, hkv, dh, *pops.visible_rows(q_pos, kv_len, skv))


# (work, expected bound in ms to 4 decimals, what binds): PERF.md's kernel table
KERNEL_BOUNDS = {
    "prefill llama3-8b chunk": (lambda: _prefill_at_end(1, 512, 2048, 32, 8, 128),
                                0.0152, "operations"),
    "prefill zamba2-2.7b": (lambda: _prefill_at_end(1, 2048, 2048, 32, 32, 80),
                            0.0217, "operations"),
    "prefill gemma2-9b chunk": (lambda: _prefill_at_end(1, 512, 4096, 16, 8, 256),
                                0.0326, "operations"),
    "prefill seamless prefix": (lambda: _prefill_at_end(4, 16, 16, 16, 16, 64, [16, 12, 8, 4]),
                                0.0001, "bytes"),
    "decode llama3-8b": (lambda: dops.work(8, 32, 8, 128,
                                           sum([2048, 1900, 1536, 1024, 700, 512, 130, 64])),
                         0.0097, "bytes"),
    "decode zamba2-2.7b": (lambda: dops.work(4, 32, 32, 80, 2080 + 1568 + 732 + 162),
                           0.0139, "bytes"),
    "decode gemma2-9b": (lambda: dops.work(8, 16, 8, 256, sum(
        [4096, 3584, 3000, 2048, 1500, 777, 256, 65])), 0.0375, "bytes"),
    "ssd_scan zamba2-2.7b": (lambda: sdops.work(4, 2048, 80, 64, 64, 128, 2), 0.0531, "bytes"),
    "ssd_scan mamba2-130m": (lambda: sdops.work(4, 2048, 24, 64, 128, 128, 2), 0.0175, "bytes"),
    "prefill_bwd minicpm-2b": (lambda: pops.bwd_work(4, 2048, 2048, 36, 36, 64,
                                                     4 * 2048 * 2049 // 2), 0.1955, "operations"),
    "prefill_bwd llama3-8b": (lambda: pops.bwd_work(1, 2048, 2048, 32, 8, 128, 2048 * 2049 // 2),
                              0.0869, "operations"),
    "ssd_bwd zamba2-2.7b": (lambda: sdops.bwd_work(4, 2048, 80, 64, 64, 128, 2), 0.1030, "bytes"),
    "ssd_bwd mamba2-130m": (lambda: sdops.bwd_work(4, 2048, 24, 64, 128, 128, 2), 0.0405,
                            "bytes"),
}


@pytest.mark.parametrize("row", list(KERNEL_BOUNDS))
def test_kernel_work_gives_the_recorded_bounds(row):
    work, ms, by = KERNEL_BOUNDS[row]
    got_ms, got_by = analysis.bound(*work(), BF16)
    assert (f"{got_ms:.4f}", got_by) == (f"{ms:.4f}", by)


def test_sched_work_is_its_two_scans():
    assert sops.work(4096, 64, 8, 8) == tuple(
        a + b for a, b in zip(sops.fcfs_work(4096), sops.pack_work(4096, 64, 8, 8), strict=True))
    assert sops.work(4096, 64, 8, 8) == (6 * 4096, 4 * 3 * 4096 + 4 + 6 * 4096 + 4 * 64
                                         + 4 * 16 + 8)


def test_train_flops_counts_as_the_train_phase_did():
    """minicpm-2b: 6 N + causal attention's 6 L H Dh S per token; zamba2-2.7b:
    3.2763e14 a step at 8 x 2048, as chip_smoke.py's train phase prints it
    (PERF.md)."""
    cfg = get_config("minicpm-2b")
    params = build_model(cfg).param_struct()
    tokens, seq = 8 * 2048, 2048
    want = tokens * (6 * cfg.count_params()
                     + 6 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim * seq)
    assert analysis.train_flops(cfg, params, tokens, seq) == want
    z = get_config("zamba2-2.7b")
    got = analysis.train_flops(z, build_model(z).param_struct(), tokens, seq)
    assert f"{got:.4e}" == "3.2763e+14"


# ----------------------------------------------------- against the reference

def _terms(mod, **kw):
    return mod.RooflineTerms(arch="x", shape="train_4k", mesh="single", **kw)


@pytest.mark.parametrize("case", [
    dict(chips=256, flops_global=256 * 197e12, bytes_global=256 * 819e9 * 0.5,
         collective_bytes_per_chip=200e9 * 0.25, model_flops=128 * 197e12),
    dict(chips=8, flops_global=3.1e15, bytes_global=7.7e14, collective_bytes_per_chip=5e11,
         model_flops=2.2e15, bytes_analytic_global=1.3e13),
    dict(chips=1, flops_global=0.0, bytes_global=1e9, collective_bytes_per_chip=0.0,
         model_flops=0.0),
])
def test_roofline_terms_equal_the_reference(case):
    port = _terms(analysis, hw=V5E_SPEC, **case).as_dict()
    assert port == _terms(jax_analysis, **case).as_dict()
    assert _terms(analysis, **case).hw is hw.H100


@pytest.mark.parametrize("shape", list(ALL_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_and_analytic_bytes_equal_the_reference(arch, shape):
    cfg, jcfg, spec = get_config(arch), jax_get_config(arch), ALL_SHAPES[shape]
    from repro.configs import ALL_SHAPES as JAX_SHAPES

    jspec = JAX_SHAPES[shape]
    assert analysis.model_flops_for(cfg, spec) == pytest.approx(
        jax_analysis.model_flops_for(jcfg, jspec), rel=REL)
    for kw in ({}, {"windowed": True}, {"n_micro": 4}):
        assert analysis.analytic_memory_bytes(cfg, spec, **kw) == pytest.approx(
            jax_analysis.analytic_memory_bytes(jcfg, jspec, **kw), rel=REL)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_chip_cost_model_on_v5e_equals_the_tpu_cost_model(arch):
    port = ChipCostModel(get_config(arch), hw=V5E_SPEC).to_calibrated()
    ref = TPUCostModel(jax_get_config(arch)).to_calibrated()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    h100 = ChipCostModel(get_config(arch), chips=1).to_calibrated()
    assert h100.transfer_bw == 900e9  # 18 NVLink links


# ------------------------------------------------------------------ op_stats

def test_op_stats_chain_of_matmuls_is_exact():
    n, iters = 256, 7

    def fn(x, w):
        for _ in range(iters):
            x = x @ w
        return x

    for dev in ("cpu", "meta"):
        st = op_stats.count(fn, torch.zeros(n, n, device=dev), torch.zeros(n, n, device=dev))
        assert st.flops == 2 * n**3 * iters
        assert st.bytes_accessed == iters * 3 * n * n * 4  # both inputs and the output
        assert st.ops == iters and st.kernels == {}


def test_op_stats_bytes_follow_the_reference_s_rules():
    table = torch.zeros(1000, 16)  # 64,000 B, read by index only
    idx = torch.tensor([3, 7], dtype=torch.long)
    vals = torch.ones(2, 16)

    def cases():
        table.view(16, 1000).t()  # views: nothing moves
        table.index_select(0, idx)  # gather: 2 x its result + the indices
        table.index_put_((idx,), vals)  # scatter: 2 x (update + indices)
        table[:2].copy_(vals)  # a copy reads its source, writes its destination
        torch.empty(10)

    st = op_stats.count(cases)
    rows = 2 * 16 * 4
    assert st.bytes_accessed == (2 * rows + 16) + 2 * (rows + 16) + 2 * rows
    assert st.flops == 0


def test_op_stats_counts_one_at_a_time_and_costs_a_flag_test_outside():
    with op_stats.counting():
        with pytest.raises(RuntimeError, match="already active"):
            with op_stats.counting():
                pass
    assert op_stats.ACTIVE is None


def _attention_inputs(dev, dtype=F32):
    g = torch.Generator().manual_seed(0)
    b, sq, skv, hq, hkv, dh = 2, 8, 24, 4, 2, 16
    q, k, v = (torch.randn(s, generator=g, dtype=dtype).to(dev) for s in (
        (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
    q_pos = (torch.arange(sq, dtype=torch.int32) + (skv - sq))[None].expand(b, sq).contiguous()
    kv_len = torch.full((b,), skv, dtype=torch.int32)
    return q, k, v, q_pos.to(dev), kv_len.to(dev)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_a_kernel_wrapper_counts_its_work_and_not_its_plain_version(dev):
    q, k, v, q_pos, kv_len = _attention_inputs(dev)
    st = op_stats.count(pops.prefill_attention, q, k, v, q_pos, kv_len)
    want = pops.work(2, 8, 4, 2, 16, *pops.visible_rows(q_pos, kv_len, 24), 4)
    assert (st.flops, st.bytes_accessed, st.ops) == (*want, 0)
    assert st.kernels == {"prefill_attention": [1, *want]}
    # and its output is the plain version's (CPU) or its shape (meta)
    out = pops.prefill_attention(q, k, v, q_pos, kv_len) if dev == "cpu" else q
    with op_stats.counting():
        counted = pops.prefill_attention(q, k, v, q_pos, kv_len)
    assert counted.shape == q.shape and counted.is_contiguous()
    if dev == "cpu":
        assert torch.equal(counted, out)
    st = op_stats.count(dops.decode_attention, q[:, 0].contiguous(), k, v, kv_len)
    assert (st.flops, st.bytes_accessed, st.ops) == (*dops.work(2, 4, 2, 16, 48, 4), 0)


def test_the_backward_kernels_count_their_work_under_grad():
    q, k, v, q_pos, kv_len = _attention_inputs("meta")
    q.requires_grad_(True)

    def fwd_bwd():
        out = pops.prefill_attention(q, k, v, q_pos, kv_len)
        torch.autograd.grad(out.sum(), q)

    st = op_stats.count(fwd_bwd)
    vis = pops.visible_rows(q_pos, kv_len, 24)[0]
    assert st.kernels["prefill_attention"] == [1, *pops.work(2, 8, 4, 2, 16, vis, 2 * 24, 4)]
    assert st.kernels["prefill_attention_bwd"] == [1, *pops.bwd_work(2, 8, 24, 4, 2, 16, vis, 4)]


def _real(t: torch.Tensor, cfg) -> torch.Tensor:
    """A CPU tensor of ``t``'s shape and dtype: token ids below the vocabulary,
    normal draws for floats."""
    g = torch.Generator().manual_seed(1)
    if t.dtype.is_floating_point:
        return torch.randn(t.shape, generator=g).to(t.dtype)
    return torch.randint(0, cfg.vocab_size, t.shape, generator=g, dtype=t.dtype)


def _cpu_inputs(cfg, spec, meta_inputs):
    """The meta inputs as CPU tensors, a decode at the cache's last row
    (the canonical layout) and a zero cache."""
    def conv(name, t):
        if isinstance(t, dict):
            return {k: conv(k, v) for k, v in t.items()}
        if name == "positions":
            return torch.full(t.shape, spec.seq_len - 1, dtype=t.dtype)
        if name == "labels" or name in ("k", "v", "conv", "state") or name.startswith(
                ("k_", "v_", "cross")):
            return torch.zeros(t.shape, dtype=t.dtype) if name != "labels" else _real(t, cfg)
        return _real(t, cfg)
    return {k: conv(k, v) for k, v in meta_inputs.items()}


STEP_ARCHS = ["llama3-8b-smoke", "phi3.5-moe-42b-a6.6b-smoke", "gemma2-9b-smoke",
              "mamba2-130m-smoke", "zamba2-2.7b-smoke", "seamless-m4t-medium-smoke",
              "chameleon-34b-smoke"]
STEP_SPECS = [ShapeSpec("prefill", 32, 2, "prefill"), ShapeSpec("decode", 32, 2, "decode"),
              ShapeSpec("train", 32, 4, "train")]


@pytest.mark.parametrize("spec", STEP_SPECS, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_a_step_counts_the_same_on_cpu_and_meta_tensors(arch, spec):
    cfg = get_config(arch)
    model = build_model(cfg)
    meta_inputs = input_specs(cfg, spec)
    meta = report.step_stats(cfg, spec, model.param_struct(), meta_inputs, n_micro=2)
    cpu = report.step_stats(cfg, spec, model.init(0, device="cpu"),
                            _cpu_inputs(cfg, spec, meta_inputs), n_micro=2)
    assert (cpu.flops, cpu.bytes_accessed, cpu.ops, cpu.kernels) == (
        meta.flops, meta.bytes_accessed, meta.ops, meta.kernels)
    assert meta.flops > 0 and meta.bytes_accessed > 0
    if cfg.family != "ssm" and spec.kind != "decode":
        assert "prefill_attention" in meta.kernels
    if spec.kind == "train" and cfg.family in ("ssm", "hybrid"):
        # 2 microbatches, each forward twice under remat: as the train phase launches
        assert meta.kernels["ssd_scan_bwd"][0] == 2 * cfg.num_layers
        assert meta.kernels["ssd_scan"][0] == 4 * cfg.num_layers


def test_a_ragged_decode_counts_what_its_data_need():
    """Meta tensors take every lane at the cache's length; on the CPU lanes
    that end earlier read fewer rows."""
    cfg = get_config("llama3-8b-smoke")
    model = build_model(cfg)
    spec = ShapeSpec("decode", 32, 2, "decode")
    meta_inputs = input_specs(cfg, spec)
    cpu_inputs = _cpu_inputs(cfg, spec, meta_inputs)
    cpu_inputs["positions"] = torch.tensor([31, 9], dtype=torch.int32)
    meta = report.step_stats(cfg, spec, model.param_struct(), meta_inputs)
    cpu = report.step_stats(cfg, spec, model.init(0, device="cpu"), cpu_inputs)
    rows = (32 + 10) * cfg.num_layers
    assert cpu.kernels["decode_attention"][1] == 4 * cfg.num_heads * cfg.resolved_head_dim * rows
    assert cpu.bytes_accessed < meta.bytes_accessed and cpu.flops < meta.flops


def test_report_over_the_smoke_archs_has_40_rows_and_picks_three_cells():
    cells = report.report_cells([a + "-smoke" for a in ASSIGNED], chips=8)
    table = report.markdown_table(cells).splitlines()
    rows = table[2:]
    assert len(rows) == 40 and sum("| skipped |" in r for r in rows) == 8
    assert all(r.count("|") == table[0].count("|") for r in rows)
    counted = [c for c in cells if c.terms is not None]
    assert all(c.terms.hw is hw.H100 and c.terms.chips == 8 for c in counted)
    assert all(np.isfinite(c.terms.step_time_bound_s) and c.terms.flops_global > 0
               for c in counted)
    picks = report.pick_hillclimb_cells(cells)
    assert sorted(picks) == ["most_collective_bound", "paper_representative", "worst_roofline"]
    assert picks["paper_representative"]["shape"] == "decode_32k"
