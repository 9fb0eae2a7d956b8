"""The schedulers as device programs (``repro_torch.core.device_sched``)
against both ``repro.core.jax_sched`` and the port's host policies, with
the criteria of tests/test_jax_sched_property.py (the same hypothesis
strategies, 40 examples each), and the ``sched_scan`` plain versions
against the reference's two ``jax.lax.scan`` loops bit for bit in f32 on
tie-free inputs. On the CPU the scans run their plain versions; the card's
kernels are held to them by chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="optional dep: hypothesis")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import jax_sched  # noqa: E402
from repro_torch.core import device_sched as ds  # noqa: E402
from repro_torch.core.lut import StepTimeLUT  # noqa: E402
from repro_torch.core.predictor import predict_all_finish_times  # noqa: E402
from repro_torch.core.request import Phase, Request, SLOSpec  # noqa: E402
from repro_torch.kernels.sched_scan.ops import fcfs_scan, slack_pack  # noqa: E402
from repro_torch.policies import SlackDecodeScheduler, UrgencyPrefillScheduler  # noqa: E402

SLO = SLOSpec(ttft=8.0, tpot=0.05)
CPU = "cpu"

arrival_lists = st.lists(
    st.integers(min_value=0, max_value=512).map(lambda x: x / 32.0),
    min_size=1, max_size=24,
)
len_lists = st.lists(st.integers(min_value=1, max_value=50_000), min_size=1, max_size=24)


def _queue(arrivals, lens):
    return [Request(rid=i, arrival=float(a), input_len=int(l), output_len=10, slo=SLO)
            for i, (a, l) in enumerate(zip(arrivals, lens, strict=True))]


def _lut():
    return StepTimeLUT(analytic=lambda b, s: 0.005 + 0.0002 * b + 2.4e-7 * s)


@given(arrival_lists, len_lists, st.integers(0, 200))
@settings(max_examples=40, deadline=None)
def test_fcfs_finish_times_match_jax_and_host(arrs, lens, tnow_i):
    n = min(len(arrs), len(lens))
    arrs, lens = arrs[:n], lens[:n]
    t_now, mu = tnow_i / 16.0, 20_000.0
    host = predict_all_finish_times(_queue(arrs, lens), t_now, mu)
    ref = jax_sched.fcfs_finish_times(jnp.asarray(arrs, jnp.float32),
                                      jnp.asarray(lens, jnp.float32), jnp.ones(n, bool),
                                      jnp.float32(t_now), jnp.float32(mu))
    out = ds.fcfs_finish_times(torch.tensor(arrs, dtype=torch.float32),
                               torch.tensor(lens, dtype=torch.float32),
                               torch.ones(n, dtype=torch.bool), t_now, mu)
    np.testing.assert_allclose(out.numpy(), host, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-4)


@given(arrival_lists, len_lists, st.integers(1, 8), st.integers(0, 4))
@settings(max_examples=40, deadline=None)
def test_urgency_select_matches_jax_and_host(arrs, lens, budget_k, pad):
    """``pad`` inactive slots after the queue: they sort last and take
    nothing."""
    n = min(len(arrs), len(lens))
    arrs, lens = arrs[:n], lens[:n]
    budget, t_now, mu = budget_k * 512, 2.0, 20_000.0
    queue = _queue(arrs, lens)
    host_take = np.zeros(n)
    for r, take in UrgencyPrefillScheduler().select(queue, t_now, mu, budget):
        host_take[r.rid] = take
    ref = np.asarray(jax_sched.urgency_select(
        jnp.asarray(arrs, jnp.float32), jnp.asarray(lens, jnp.float32),
        jnp.asarray(lens, jnp.float32), jnp.ones(n, bool), jnp.float32(t_now),
        jnp.float32(mu), jnp.float32(SLO.ttft), budget))
    slots = ds.prefill_slots(queue, n + pad, device=CPU)
    out = ds.urgency_select(slots["arrivals"], slots["input_lens"], slots["remaining"],
                            slots["active"], t_now, mu, slots["slo_ttft"], budget).numpy()
    assert not out[n:].any()
    out = out[:n]
    # scores can tie under f32: the totals agree within a token, and the
    # per-slot takes wherever nothing is tied
    assert out.sum() == pytest.approx(host_take.sum(), abs=1.0)
    assert out.sum() == pytest.approx(ref.sum(), abs=1.0)
    u = UrgencyPrefillScheduler().urgency_scores(queue, t_now, mu)
    if len(set(np.round(u * 1e7).astype(np.int64))) == n:
        np.testing.assert_allclose(out, host_take, atol=1.0)
        np.testing.assert_allclose(out, ref, atol=1.0)


def _decoding(seqs, ngens):
    reqs = []
    for i, (s, g) in enumerate(zip(seqs, ngens, strict=True)):
        r = Request(rid=i, arrival=0.0, input_len=s - min(g, s - 1), output_len=1000, slo=SLO)
        r.n_generated = r.n_decoded = min(g, s - 1)
        r.first_token_time = r.decode_start = 99.0
        r.phase = Phase.DECODE
        reqs.append(r)
    return reqs


@given(
    st.lists(st.integers(64, 200_000), min_size=1, max_size=24),
    st.lists(st.integers(0, 400), min_size=1, max_size=24),
    st.integers(0, 40),
    st.integers(0, 4),
)
@settings(max_examples=40, deadline=None)
def test_slack_select_matches_jax_and_host(seqs, ngens, dt_i, pad):
    n = min(len(seqs), len(ngens))
    reqs = _decoding(seqs[:n], ngens[:n])
    t_now = 100.0 + dt_i / 100.0
    lut = _lut()
    batch, _ = SlackDecodeScheduler(lut, slo_margin=1.0).select(reqs, t_now)
    host = np.zeros(n, bool)
    for r in batch:
        host[r.rid] = True
    be, se, tab = lut.as_arrays()
    ref = jax_sched.slack_select(
        jnp.asarray([r.seq_len for r in reqs], jnp.int32),
        jnp.asarray([r.n_decoded for r in reqs], jnp.int32),
        jnp.asarray([r.decode_start for r in reqs], jnp.float32), jnp.ones(n, bool),
        jnp.float32(t_now), jnp.float32(SLO.tpot), jnp.asarray(tab), jnp.asarray(be),
        jnp.asarray(se))
    slots = ds.decode_slots(reqs, n + pad, device=CPU)
    sel = ds.slack_select(slots["seq_lens"], slots["n_gen"], slots["first_token_t"],
                          slots["active"], t_now, slots["slo_tpot"], *ds.lut_tensors(lut, CPU))
    got = sel.selected.numpy()
    assert not got[n:].any() and int(sel.batch_size) == int(got.sum())
    got = got[:n]
    # f32-vs-f64 boundary ties can flip single decisions: the batch size
    # agrees within 1, and the fallback (decode all) exactly
    for want in (host, np.asarray(ref.selected)):
        if want.all():
            assert got.all()
        else:
            assert abs(int(got.sum()) - int(want.sum())) <= 1


def test_lut_lookup_and_update_match_jax_and_host():
    lut = _lut()
    table, be, se = ds.lut_tensors(lut, CPU)
    jbe, jse, jtab = (jnp.asarray(x) for x in lut.as_arrays())
    v = ds.lut_lookup(table, be, se, 4, 10_000)
    assert float(v) == pytest.approx(lut.lookup(4, 10_000), rel=1e-6)
    assert float(v) == float(jax_sched.lut_lookup(jtab, jbe, jse, jnp.int32(4), jnp.int32(10_000)))
    grid = ds.lut_lookup(table, be, se, torch.tensor([[1, 300]]), torch.tensor([[1, 2_000_000]]))
    assert grid.shape == (1, 2)
    assert grid[0, 1] == pytest.approx(lut.lookup(300, 2_000_000), rel=1e-6)
    counts = torch.ones_like(table)
    t2, c2 = ds.lut_update(table, counts, be, se, 4, 10_000, 1.0)
    jt2, _ = jax_sched.lut_update(jtab, jnp.ones_like(jtab), jbe, jse, jnp.int32(4),
                                  jnp.int32(10_000), jnp.float32(1.0))
    lut.update(4, 10_000, 1.0)
    assert float(ds.lut_lookup(t2, be, se, 4, 10_000)) == pytest.approx(lut.lookup(4, 10_000),
                                                                        rel=1e-6)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
    assert int(c2.sum()) == table.numel() + 1 and counts.sum() == table.numel()


@given(st.lists(st.integers(0, 1 << 20), min_size=1, max_size=24, unique=True),
       len_lists, st.integers(0, 200))
@settings(max_examples=40, deadline=None)
def test_fcfs_scan_plain_version_equals_the_lax_scan_bitwise(arr_i, lens, tnow_i):
    """Tie-free arrivals (one arrival order): the FCFS finish times equal the
    reference's bit for bit in f32."""
    n = min(len(arr_i), len(lens))
    arrs = (np.asarray(arr_i[:n]) / 4096.0).astype(np.float32)
    lens = np.asarray(lens[:n], np.float32)
    t_now, mu = np.float32(tnow_i / 7.0), np.float32(20_000.0)
    ref = jax_sched.fcfs_finish_times(jnp.asarray(arrs), jnp.asarray(lens), jnp.ones(n, bool),
                                      jnp.float32(t_now), jnp.float32(mu))
    out = ds.fcfs_finish_times(torch.from_numpy(arrs), torch.from_numpy(lens),
                               torch.ones(n, dtype=torch.bool), float(t_now), float(mu))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@given(st.lists(st.integers(64, 200_000), min_size=1, max_size=24, unique=True),
       st.lists(st.integers(0, 400), min_size=1, max_size=24), st.integers(0, 40))
@settings(max_examples=40, deadline=None)
def test_slack_pack_plain_version_equals_the_lax_scan_bitwise(seqs, ngens, dt_i):
    """Tie-free sequence lengths (one walk order), slot by slot on the same
    s_min as the reference's: the greedy walk selects the same slots and
    batch size."""
    n = min(len(seqs), len(ngens))
    reqs = _decoding(seqs[:n], ngens[:n])
    be, se, tab = _lut().as_arrays()
    ref = jax_sched.slack_select(
        jnp.asarray([r.seq_len for r in reqs], jnp.int32),
        jnp.asarray([r.n_decoded for r in reqs], jnp.int32),
        jnp.full((n,), 99.0, jnp.float32), jnp.ones(n, bool), jnp.float32(99.0 + dt_i / 1000.0),
        jnp.float32(SLO.tpot), jnp.asarray(tab), jnp.asarray(be), jnp.asarray(se))
    seq = torch.tensor([r.seq_len for r in reqs], dtype=torch.int32)
    order = torch.argsort(seq, stable=True)
    sel_s, count = slack_pack(seq[order], torch.ones(n, dtype=torch.bool),
                              torch.tensor([float(ref.s_min)]), torch.from_numpy(tab),
                              torch.from_numpy(be), torch.from_numpy(se))
    selected = torch.empty_like(sel_s).index_put_((order,), sel_s)
    if int(count[0]) == 0:  # the reference's fallback: decode all
        assert np.asarray(ref.selected).all() and int(ref.batch_size) == n
    else:
        np.testing.assert_array_equal(selected.numpy(), np.asarray(ref.selected))
        assert int(count[0]) == int(ref.batch_size)


def test_scans_take_their_plain_versions_on_the_cpu_only():
    a = torch.tensor([0.0, 1.0, 1.5])
    out = fcfs_scan(a, torch.tensor([2.0, 0.25, 0.5]), torch.tensor([0.5]))
    assert out.tolist() == [2.5, 2.75, 3.25]
    with pytest.raises(ValueError, match="unsupported device"):
        fcfs_scan(a.to("meta"), a.to("meta"), a[:1].to("meta"))
    if not torch.cuda.is_available():
        for call in (lambda: ds.prefill_slots([]), lambda: ds.decode_slots([]),
                     lambda: ds.lut_tensors(_lut())):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
