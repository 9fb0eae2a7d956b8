"""The traced record's program spans, events, and device time by kernel and
by program range: the reduction of a synthetic trace, the five readers
that read them, the old readers unmoved by them, and a metric that is one
new file."""
import dataclasses
import sys
import types

import pytest

from kbench import spec
from kbench.bench import kernel_wrappers
from kbench.profiling import reduce_trace, split_events
from kbench.record import engine_calls, program_spans
from kbench.spec import reader

MODEL = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1, head_dim=4, d_ff=16,
             vocab_size=32, num_experts=0, engine=dict(chunk_size=4))

# a synthetic slice, in microseconds: one decode.forward range holding a
# moe.experts range, a second decode.forward, a prefill.chunk; the
# benchmark's kb.decode_step around the forwards. The first forward's
# device annotation runs on over gather_k, which no range launched.
PROGRAM = [("decode.forward", 100.0, 200.0), ("moe.experts", 120.0, 150.0),
           ("decode.forward", 300.0, 400.0), ("prefill.chunk", 500.0, 600.0)]
ANNOTATIONS = [("decode.forward", 110.0, 245.0), ("decode.forward", 310.0, 330.0),
               ("prefill.chunk", 520.0, 640.0)]
KB = [("kb.decode_step", 90.0, 410.0)]
DEVICE = [  # (name, start, end, launch)
    ("gemm_a", 110.0, 130.0, 105.0),     # forward 1; launched before moe.experts
    ("expert_k", 140.0, 170.0, 125.0),   # forward 1 and moe.experts
    ("expert_k", 180.0, 190.0, 140.0),   # forward 1 and moe.experts
    ("gather_k", 230.0, 240.0, 210.0),   # no range; inside forward 1's annotation
    ("gemm_a", 250.0, 260.0, 190.0),     # forward 1; after its annotation
    ("gemm_a", 310.0, 330.0, 305.0),     # forward 2
    ("chunk_k", 520.0, 560.0, 510.0),    # prefill.chunk
    ("chunk_k", 590.0, 640.0, None),     # no launch in the trace: by the annotation
]
# busy: [110,130] [140,170] [180,190] [230,240] [250,260] [310,330] [520,560] [590,640]
# gaps (midpoint): 130-140 (135), 170-180 (175), 190-230 (210), 240-250 (245),
# 260-310 (285), 330-520 (425), 560-590 (575)


def _reduced(**kw):
    args = dict(program=PROGRAM, annotations=ANNOTATIONS,
                wrappers={"moe.expert_k": 2, "decode_attention.decode_attention": 0})
    args.update(kw)
    return reduce_trace(DEVICE, KB, 1e-3, {"decode_attention": 0}, **args)


def _bare():
    return reduce_trace(DEVICE, KB, 1e-3, {"decode_attention": 0}, (), (), {})


def test_every_kernel_with_its_time_and_count():
    s = _reduced()
    assert s["kernels"] == {
        "gemm_a": dict(device_s=pytest.approx(50e-6), count=3),
        "expert_k": dict(device_s=pytest.approx(40e-6), count=2),
        "gather_k": dict(device_s=pytest.approx(10e-6), count=1),
        "chunk_k": dict(device_s=pytest.approx(90e-6), count=2),
    }
    assert s["wrapper_launches"] == {"moe.expert_k": 2, "decode_attention.decode_attention": 0}


def test_program_ranges_by_launch_and_by_annotation():
    pr = _reduced()["program_ranges"]
    assert set(pr) == {"decode.forward", "decode.forward/moe.experts", "prefill.chunk"}
    fwd = pr["decode.forward"]
    # launched at 105, 125, 140, 190 and 305; not gather_k, though its
    # midpoint lies in the forward's annotation
    assert fwd["count"] == 2 and fwd["host_s"] == pytest.approx(200e-6)
    assert fwd["device_s"] == pytest.approx(90e-6)
    assert fwd["kernels"] == {"gemm_a": dict(device_s=pytest.approx(50e-6), count=3),
                              "expert_k": dict(device_s=pytest.approx(40e-6), count=2)}
    assert fwd["by_annotation"] == 0
    # the gaps at 135 and 175 lie in 100-200; none lies in 300-400
    assert fwd["idle_s"] == pytest.approx(20e-6)
    moe = pr["decode.forward/moe.experts"]
    assert moe["count"] == 1 and moe["host_s"] == pytest.approx(30e-6)
    assert moe["kernels"] == {"expert_k": dict(device_s=pytest.approx(40e-6), count=2)}
    assert moe["idle_s"] == pytest.approx(10e-6)  # the gap at 135
    chunk = pr["prefill.chunk"]
    # one chunk_k by its launch, the one without a launch by the annotation
    assert chunk["kernels"] == {"chunk_k": dict(device_s=pytest.approx(90e-6), count=2)}
    assert chunk["by_annotation"] == 1
    assert chunk["idle_s"] == pytest.approx(30e-6)  # 560-590


def test_without_annotations_a_kernel_with_no_launch_is_in_no_range():
    pr = _reduced(annotations=())["program_ranges"]
    assert pr["prefill.chunk"]["kernels"] == {"chunk_k": dict(device_s=pytest.approx(40e-6),
                                                              count=1)}
    assert pr["decode.forward"] == _reduced()["program_ranges"]["decode.forward"]


def test_without_launches_the_annotations_place_every_kernel():
    device = [d[:3] + (None,) for d in DEVICE]
    pr = reduce_trace(device, KB, 1e-3, {}, PROGRAM, ANNOTATIONS, {})["program_ranges"]
    fwd = pr["decode.forward"]
    # midpoints 120, 155, 185, 235 (gather_k) and 320; not 255
    assert fwd["device_s"] == pytest.approx((20 + 30 + 10 + 10 + 20) * 1e-6)
    assert fwd["by_annotation"] == 5
    assert pr["decode.forward/moe.experts"]["kernels"] == {}  # it has no annotation


def test_the_existing_summary_is_unchanged_by_the_program_ranges():
    with_ranges, without = _reduced(), _bare()
    for key in ("window_s", "busy_s", "group_s", "top_ops", "idle_gaps", "calls", "launches",
                "complete"):
        assert with_ranges[key] == without[key]
    assert without["program_ranges"] == {} and without["wrapper_launches"] == {}


@dataclasses.dataclass
class _Event:
    name: str
    kind: str
    start: float
    end: float
    id: int = 0
    is_user_annotation: bool = False

    @property
    def device_type(self):
        return types.SimpleNamespace(name=self.kind)

    @property
    def time_range(self):
        return types.SimpleNamespace(start=self.start, end=self.end)


def test_split_events_sorts_the_profilers_events():
    events = [
        _Event("kb.decode_step", "CPU", 90, 410, is_user_annotation=True),
        _Event("decode.forward", "CPU", 100, 200, is_user_annotation=True),
        _Event("aten::mm", "CPU", 101, 104, id=7),
        _Event("cudaLaunchKernel", "CPU", 105, 106, id=42),
        _Event("gemm_a", "CUDA", 110, 130, id=42),
        _Event("gemm_b", "CUDA", 131, 132, id=43),  # its launch is not in the trace
        _Event("decode.forward", "CUDA", 110, 130, is_user_annotation=True),
        _Event("kb.decode_step", "CUDA", 110, 132, is_user_annotation=True),
    ]
    device, ranges, program, annotations = split_events(events)
    assert device == [("gemm_a", 110, 130, 105), ("gemm_b", 131, 132, None)]
    assert ranges == [("kb.decode_step", 90, 410)]
    assert program == [("decode.forward", 100, 200)]
    assert annotations == [("decode.forward", 110, 130)]


def test_kernel_wrappers_are_found_by_package(monkeypatch, tmp_path):
    import repro_torch.kernels as kernels

    found = kernel_wrappers()
    assert {"decode_attention.decode_attention", "prefill_attention.prefill_attention",
            "prefill_attention.prefill_attention_bwd", "ssd_scan.ssd"} <= set(found)
    assert all(isinstance(f(), int) for f in found.values())
    # a wrapper added later is found without an edit
    pkg = tmp_path / "expert_gemm"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "ops.py").write_text("def expert_gemm(x):\n    expert_gemm.launches += 1\n"
                                "expert_gemm.launches = 3\n")
    monkeypatch.setattr(kernels, "__path__", list(kernels.__path__) + [str(tmp_path)])
    try:
        assert kernel_wrappers()["expert_gemm.expert_gemm"]() == 3
    finally:
        for m in ("repro_torch.kernels.expert_gemm", "repro_torch.kernels.expert_gemm.ops"):
            sys.modules.pop(m, None)


# a record: two decode steps and a prefill chunk ending in the window
# (10, 20), one decode step and one chunk ending after it
def _step(t, gather, fwd, scatter, pool="engine:0"):
    """One decode call's spans from ``t``: gather, forward, scatter, sample
    and wait, each host length 1 ms but the forward's ``fwd``."""
    out, names = [], ["decode.gather", "decode.forward", "decode.scatter", "decode.sample",
                      "decode.wait"]
    lengths = [1e-3, fwd, 1e-3, 1e-3, 1e-3]
    devs = [gather, fwd / 2, scatter, 1e-4, None]
    for n, length, d in zip(names, lengths, devs):
        out.append((n, pool, t, t + length, d, {}))
        t += length
    return out


SPANS = (_step(11.0, 0.03, 0.08, 0.0002)
         + [("prefill.chunk", "engine:0", 12.0, 12.2, 0.15, dict(rid=1, start=0, take=512))]
         + _step(13.0, 0.01, 0.06, 0.0004)
         + [("prefill.chunk", "engine:0", 19.9, 20.5, 0.4, dict(rid=2, start=512, take=100))]
         + _step(19.99, 0.05, 0.09, 0.0001))
EVENTS = [("decode_step", 11.1, -1, dict(batch=4, step_time=0.08, made_up_counter=3)),
          ("decode_step", 13.1, -1, dict(batch=2, step_time=0.06, made_up_counter=5)),
          ("token", 13.2, 7, {})]
PROFILE = dict(window_s=2.0, busy_s=1.5, span=(11.0, 13.0),
               group_s={"prefill_attention": 0.01, "decode_attention": 0.02},
               launches={"prefill_attention": 4, "decode_attention": 2},
               program_ranges={
                   "decode.forward": dict(count=4, host_s=0.4, device_s=0.1, idle_s=0.3,
                                          kernels={}, by_annotation=0),
                   "decode.forward/moe.experts": dict(count=64, host_s=0.1, device_s=0.03,
                                                      idle_s=0.02, by_annotation=0,
                                                      kernels={"expert_k": dict(
                                                          device_s=0.025, count=64)}),
                   "decode.forward/moe.route": dict(count=64, host_s=0.1, device_s=0.002,
                                                    idle_s=0.02, kernels={}, by_annotation=0),
                   "decode.forward/moe.route/inner": dict(count=64, host_s=0.1, device_s=0.001,
                                                          idle_s=0.0, by_annotation=0,
                                                          kernels={}),
                   "prefill.chunk/moe.experts": dict(count=4, host_s=0.1, device_s=0.5,
                                                     idle_s=0.0, kernels={}, by_annotation=0),
               },
               kernels={"expert_k": dict(device_s=0.04, count=80)},
               wrapper_launches={"prefill_attention.prefill_attention": 4,
                                 "decode_attention.decode_attention": 2})


def rec(**kw):
    base = dict(window=(10.0, 20.0), rows=[], prefill_spans=[], decode_spans=[], steps=[],
                events=EVENTS, program_spans=SPANS, model=MODEL, setup_s=12.5, profile=PROFILE)
    base.update(kw)
    return base


def test_engine_calls_group_each_decode_step():
    calls = engine_calls(rec(), "decode")
    assert [len(c) for c in calls] == [5, 5]  # the third ends after the window
    assert [c[0][2] for c in calls] == [11.0, 13.0]
    assert [c[0] for c in engine_calls(rec(), "prefill")] == [SPANS[5]]
    assert program_spans(rec(), "prefill.chunk") == [SPANS[5]]
    # a call begins where a name repeats, even at the same clock reading
    same = _step(11.0, 0.01, 0.02, 0.0)
    again = [(n, p, t0 - 11.0 + same[-1][3], t1 - 11.0 + same[-1][3], d, x)
             for n, p, t0, t1, d, x in same]
    assert [len(c) for c in engine_calls(rec(program_spans=same + again), "decode")] == [5, 5]
    # or where another pool's call comes between
    other = _step(11.5, 0.01, 0.02, 0.0, pool="engine:1")
    assert len(engine_calls(rec(program_spans=same[:2] + other + same[2:]), "decode")) == 3


NEW = {
    "decode_kv_copy_ms": 1e3 * ((0.03 + 0.0002) + (0.01 + 0.0004)) / 2,
    "decode_launch_ms": 1e3 * ((0.08 + 3e-3) + (0.06 + 3e-3)) / 2,
    "prefill_chunk_ms_per_ktok": 1e6 * 0.15 / 512,
    "decode_forward_idle_share": 100.0 * 0.3 / 0.4,
    "moe_decode_ms": 1e3 * (0.03 + 0.002) / 4,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_reads_the_hand_computed_value(name):
    assert reader(name)(rec()) == pytest.approx(NEW[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_reader_reads_nothing_without_spans_or_profile(name):
    assert reader(name)(rec(program_spans=[], events=[], profile=None)) is None


def test_span_readers_read_nothing_off_the_card():
    off = [s[:4] + (None,) + s[5:] for s in SPANS]
    assert reader("decode_kv_copy_ms")(rec(program_spans=off)) is None
    assert reader("prefill_chunk_ms_per_ktok")(rec(program_spans=off)) is None
    assert reader("decode_launch_ms")(rec(program_spans=off)) == \
        pytest.approx(NEW["decode_launch_ms"])


def test_moe_reader_needs_a_moe_range_inside_the_forward():
    ranges = {k: v for k, v in PROFILE["program_ranges"].items() if "moe" not in k}
    assert reader("moe_decode_ms")(rec(profile=dict(PROFILE, program_ranges=ranges))) is None


OLD = ["prefill_queue_p95_s", "decode_batch_mean", "prefill_ms_per_ktok", "decode_step_ms",
       "mfu.prefill", "mfu.decode", "prefill_attention_roofline", "decode_attention_roofline",
       "device_idle_share", "tpot_p95_ms", "ttft_p50_s", "output_tokens_per_s", "setup_s"]


def _old_record():
    rows = [dict(due=11.0, times=[11.5, 12.0, 12.2], prefill_start=11.2),
            dict(due=12.0, times=[13.0, 13.5], prefill_start=12.5)]
    prof = {k: v for k, v in PROFILE.items()
            if k not in ("program_ranges", "kernels", "wrapper_launches")}
    return dict(window=(10.0, 20.0), rows=rows,
                prefill_spans=[(11.5, 11.6, 4, 0), (12.0, 12.1, 3, 4)],
                decode_spans=[(12.2, 12.3, 2, 2, [9, 5])],
                steps=[(11.1, 4, 0.08), (13.1, 2, 0.06)], model=MODEL, setup_s=12.5,
                profile=prof)


@pytest.mark.parametrize("name", OLD)
def test_existing_reader_reads_the_same_with_the_new_fields(name):
    old = _old_record()
    new = dict(old, events=EVENTS, program_spans=SPANS,
               profile=dict(old["profile"], program_ranges=PROFILE["program_ranges"],
                            kernels=PROFILE["kernels"],
                            wrapper_launches=PROFILE["wrapper_launches"]))
    v = reader(name)(old)
    assert v is not None
    assert reader(name)(new) == v  # float for float


def test_a_metric_that_is_one_new_file(monkeypatch, tmp_path):
    """A counter in a DECODE_STEP event's data, and a kernel's time inside a
    range, read by a reader file the harness finds by name; no file of
    kbench/ edited."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "made_up.py").write_text(
        "from kbench.record import due_in_window\n\n"
        "def read(rec):\n"
        "    t0, t1 = rec['window']\n"
        "    n = sum(e[3]['made_up_counter'] for e in rec['events']\n"
        "            if e[0] == 'decode_step' and t0 <= e[1] <= t1)\n"
        "    r = rec['profile']['program_ranges'].get('made.up/range')\n"
        "    k = r['kernels'].get('made_up_kernel') if r else None\n"
        "    return None if k is None else n + 1e6 * k['device_s']\n")
    device = [("made_up_kernel", 10.0, 14.0, 9.0), ("other", 15.0, 16.0, 9.5)]
    profile = reduce_trace(device, [], 1e-3, {}, [("made.up", 5.0, 20.0), ("range", 8.0, 9.2)],
                           (), {})
    monkeypatch.setattr(spec, "KBENCH", tmp_path)
    assert reader("made_up")(rec(profile=profile)) == pytest.approx(3 + 5 + 4.0)
    assert reader("made_up")(rec(profile=dict(profile, program_ranges={}))) is None
