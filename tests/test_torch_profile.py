"""``repro_torch.launch.profile`` attributes device time to the
``prefill_chunk``/``decode_step`` ranges by timestamp (ROADMAP C5): on a
synthetic event list of the profiler's own event type, a kernel that no
ATen op encloses (a ``ctypes`` launch) lands in the range it ran in, and
the ranges plus the outside line sum to the device's busy time."""
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.autograd.profiler_util import FunctionEvent  # noqa: E402

from repro_torch.launch.profile import device_kernels, range_device_time  # noqa: E402

_ids = iter(range(1, 1000))


def _cpu(name, t0, t1, thread=1):
    return FunctionEvent(next(_ids), name, thread, t0, t1, device_type=DeviceType.CPU)


def _dev(name, t0, t1, annotation=False):
    return FunctionEvent(next(_ids), name, 7, t0, t1, device_type=DeviceType.CUDA,
                         is_user_annotation=annotation)


def _trace():
    """Two decode steps and a prefill chunk on the host, each ending in a
    sync. The first step's matmul has its ATen op; its attention kernel
    (``decode_split``) has none, as a ctypes launch has none. A copy runs
    between two ranges, and the profiler's device-side copy of a range
    spans the idle gap too."""
    step0, chunk, step1 = (_cpu("decode_step", 0, 100), _cpu("prefill_chunk", 150, 400),
                           _cpu("decode_step", 450, 520))
    mm = _cpu("aten::mm", 10, 20)
    mm.cpu_parent = step0
    step0.cpu_children.append(mm)
    return [
        step0, mm, chunk, step1,
        _dev("nvjet_tst_128x64", 20, 50),        # the matmul, ATen parent mm
        _dev("decode_split_kernel", 50, 80),     # ctypes launch: no parent anywhere
        _dev("decode_combine_kernel", 80, 90),
        _dev("Memcpy HtoD (Pageable -> Device)", 120, 125),  # between the ranges
        _dev("prefill_attention_wgmma", 300, 390),
        _dev("decode_split_kernel", 470, 505),
        _dev("decode_step", 0, 520, annotation=True),  # the device-side range copy
    ]


def test_ranges_plus_outside_sum_to_busy_and_parentless_kernels_land_in_their_range():
    events = _trace()
    kernels = device_kernels(events)
    assert [k[0] for k in kernels].count("decode_step") == 0  # annotations left out
    busy = sum(k1 - k0 for _, k0, k1 in kernels)
    assert busy == 30 + 30 + 10 + 5 + 90 + 35
    inside, count, outside = range_device_time(events, kernels)
    assert count == {"prefill_chunk": 1, "decode_step": 2}
    assert inside == {"decode_step": 30 + 30 + 10 + 35, "prefill_chunk": 90}
    assert outside == 5
    assert sum(inside.values()) + outside == busy
    # the attention kernels alone: every one inside its range, none outside
    attn = [k for k in kernels if k[0].startswith(("decode_", "prefill_attention"))]
    inside, _, outside = range_device_time(events, attn)
    assert inside == {"decode_step": 75, "prefill_chunk": 90} and outside == 0


def test_kernel_before_the_first_range_and_after_the_last_is_outside():
    events = [_cpu("prefill_chunk", 100, 200), _dev("a", 0, 10), _dev("b", 150, 160),
              _dev("c", 250, 260)]
    inside, count, outside = range_device_time(events, device_kernels(events))
    assert inside == {"prefill_chunk": 10, "decode_step": 0}
    assert count == {"prefill_chunk": 1, "decode_step": 0}
    assert outside == 20
