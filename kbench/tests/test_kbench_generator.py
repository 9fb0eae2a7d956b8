"""The traffic generator's frozen copies draw what the port's
``sim.trace.LengthDist`` and ``workloads.arrivals.PoissonArrivals`` draw,
and every seed gets the same work in another order: in an open loop the
same requests in the lead-in and in the window, in a closed loop the same
pool."""
import numpy as np
import pytest

from kbench.traffic.generator import Mix, clip_to_context, poisson_times, sample_lengths
from repro_torch.sim.trace import LengthDist
from repro_torch.workloads.arrivals import PoissonArrivals
from repro_torch.workloads.scenarios import _INTERACTIVE_LENGTHS

_INTERACTIVE = dict(long_frac=0.0, short_median=600.0, short_sigma=0.6, max_input=8192,
                    out_median_short=150.0, max_output=1000)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
@pytest.mark.parametrize("kw,dist", [({}, LengthDist()), (_INTERACTIVE, _INTERACTIVE_LENGTHS)])
def test_lengths_equal_the_ports(seed, kw, dist):
    a = sample_lengths(500, np.random.default_rng(seed), **kw)
    b = dist.sample(500, np.random.default_rng(seed))
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_poisson_equals_the_ports(seed):
    np.testing.assert_array_equal(poisson_times(300, 0.7, np.random.default_rng(seed)),
                                  PoissonArrivals(0.7).times(300, np.random.default_rng(seed)))


def test_clip_fits_the_context():
    assert clip_to_context(24000, 300, 4096) == (3795, 300)
    assert clip_to_context(100, 4000, 4096) == (100, 2048)
    assert clip_to_context(1000, 200, 4096) == (1000, 200)


def _open_mix():
    return Mix("t", dict(loop="open", rate=0.5, pool_seed=3, lead_in_s=10, slo=dict(
        ttft_s=8, tpot_s=0.05)))


def test_seeds_share_the_work_in_another_order():
    mix = _open_mix()
    a = mix.draw(1, 30, 4096, 1000)
    b = mix.draw(2**31 + 5, 30, 4096, 1000)
    assert len(a) == len(b) == 20
    assert [r.input_len for r in a] != [r.input_len for r in b]
    for lo, hi, m in ((0.0, 10.0, 5), (10.0, 40.0, 15)):  # the lead-in, the window
        seg = [[r for r in rs if lo <= r.due < hi] for rs in (a, b)]
        assert len(seg[0]) == len(seg[1]) == m
        assert sorted((r.input_len, r.output_len) for r in seg[0]) == \
            sorted((r.input_len, r.output_len) for r in seg[1])
        # the same gaps, the one from the segment's last request to its end among them
        gaps = [sorted(np.round(np.diff([lo] + [r.due for r in s] + [hi]), 9)) for s in seg]
        assert gaps[0] == gaps[1]
        assert [r.due for r in seg[0]] != [r.due for r in seg[1]]
    for r in a:
        assert len(r.prompt) == r.input_len and r.input_len + r.output_len <= 4095
        assert min(r.prompt) >= 2


def test_open_loop_counts_follow_the_rate():
    mix = _open_mix()
    for seconds in (1, 7, 30, 51):
        reqs = mix.draw(3, seconds, 4096, 1000)
        assert sum(r.due < 10 for r in reqs) == 5
        assert sum(10 <= r.due < 10 + seconds for r in reqs) == max(1, round(0.5 * seconds))
        assert all(r.due < 10 + seconds for r in reqs)


def test_same_seed_same_requests():
    mix = _open_mix()
    a, b = mix.draw(9, 30, 4096, 1000), mix.draw(9, 30, 4096, 1000)
    assert [(r.due, r.input_len, r.prompt) for r in a] == [(r.due, r.input_len, r.prompt)
                                                           for r in b]


def test_fixed_order_sends_every_seed_the_same_schedule():
    mix = Mix("t", dict(_open_mix().params, order="fixed"))
    a = mix.draw(1, 30, 4096, 1000)
    b = mix.draw(2**31 + 5, 30, 4096, 1000)
    assert [(r.due, r.input_len, r.output_len) for r in a] == \
        [(r.due, r.input_len, r.output_len) for r in b]
    assert all(x.prompt != y.prompt for x, y in zip(a, b))
    permuted = _open_mix().draw(1, 30, 4096, 1000)
    assert sorted(r.input_len for r in permuted) == sorted(r.input_len for r in a)


def test_closed_loop_pool():
    mix = Mix("c", dict(loop="closed", clients=4, pool_per_client=5, pool_seed=3, lead_in_s=5,
                        lengths=_INTERACTIVE, slo=dict(ttft_s=8, tpot_s=0.05)))
    reqs = mix.draw(4, 30, 4096, 1000)
    assert len(reqs) == 20 and all(r.due == 0.0 for r in reqs)


def test_closed_loop_cycles_the_pool_with_prompts_of_its_own():
    kw = dict(loop="closed", clients=4, pool_per_client=2, pool_seed=3, lead_in_s=5,
              lengths=_INTERACTIVE, slo=dict(ttft_s=8, tpot_s=0.05))
    reqs = Mix("c", dict(kw, requests_per_client=5)).draw(4, 30, 4096, 1000)
    assert len(reqs) == 20 and all(r.due == 0.0 for r in reqs)
    sizes = [(r.input_len, r.output_len) for r in reqs]
    assert sizes == sizes[:8] * 2 + sizes[:4]
    assert sizes[:8] == [(r.input_len, r.output_len)
                         for r in Mix("c", kw).draw(4, 30, 4096, 1000)]
    assert len({tuple(r.prompt) for r in reqs}) == 20
