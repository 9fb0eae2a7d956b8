"""The port's evaluation harness (``repro_torch.workloads.harness``) and its
CLIs (``repro_torch.launch.{evaluate,loadgen}``) against the JAX package's,
on ``llama3-8b-smoke`` in f32 with the JAX bundle's parameters bridged into
the port's bundle, every server on a ManualClock: for each of the six
backends (router with 1 and 2 replicas, disagg 1P:1D ``never`` and 2P:1D
``slack-aware``, churn with a kill and ``queue-threshold``, paged cells)
``evaluate_cell`` gives the JAX cell in every key but ``wall_time_s``,
trace block included; the CLIs emit the same JSON; then torch twins of the
reference's harness invariants (tests/test_workloads_harness.py) that no
parity case covers."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.loadgen as jax_loadgen_mod  # noqa: E402
from repro.launch.evaluate import main as jax_evaluate_main  # noqa: E402
from repro.workloads import harness as jax_harness  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import loadgen as loadgen_mod  # noqa: E402
from repro_torch.launch.evaluate import main as evaluate_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.workloads import (  # noqa: E402
    BACKENDS,
    HarnessConfig,
    generate_scenario,
    run_grid,
    to_engine_requests,
)
from repro_torch.workloads import harness  # noqa: E402
from repro_torch.workloads.harness import (  # noqa: E402
    _EngineBundle,
    evaluate_cell,
    parse_kills,
    parse_pools,
)

CELL_KEYS = {
    "scenario", "prefill", "decode", "backend", "wall_time_s", "n_requests",
    "n_completed", "attainment", "per_tenant", "per_class", "goodput", "shed",
    "cancelled",
}
# harness knobs keep start + chunk_size <= max_len (64 >= 24 + 16), so the
# port's C1 repair never shows (ROADMAP §C)
N = 12


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle) with equal f32 weights, each built once."""
    jb = jax_harness._EngineBundle("llama3-8b-smoke").build()
    cfg = get_config("llama3-8b-smoke").replace(dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jb.params), cfg, device="cpu")
    tb = _EngineBundle("llama3-8b-smoke", device="cpu", model=build_model(cfg),
                       params=params).build()
    return jb, tb


def _cells(report):
    """A report's cells without the host wall time, the one key that is
    not a function of the schedule."""
    out = []
    for c in report["cells"]:
        c = dict(c)
        c.pop("wall_time_s")
        out.append(c)
    return out


# ------------------------------------------------------------------ parity
PARITY = [
    ("paper-longtail", "sim", {}),
    ("paper-longtail", "engine", {"trace": None}),
    ("paper-longtail", "engine", {}),
    ("paper-longtail", "async-engine", {}),
    ("paper-longtail", "router", {"router_replicas": 1}),
    ("paper-longtail", "router", {"router_replicas": 2}),
    ("paper-longtail", "disagg", {"disagg_prefill": 1, "disagg_decode": 1,
                                  "deflect_policy": "never"}),
    ("paper-longtail", "disagg", {"disagg_prefill": 2, "disagg_decode": 1,
                                  "deflect_policy": "slack-aware"}),
    ("paper-longtail", "churn", {"router_replicas": 2, "churn_kills": ((0.009, 1),),
                                 "autoscaler_policy": "queue-threshold"}),
    ("multi-tenant", "sim", {}),
    ("multi-tenant", "engine", {"tenant_quota": 2, "engine_arrival_scale": 1e-3}),
    ("multi-tenant", "churn", {"router_replicas": 2, "churn_kills": ((0.009, 1),),
                               "autoscaler_policy": "queue-threshold"}),
    ("prefix-heavy", "engine", {"page_size": 4}),
    ("prefix-heavy", "router", {"page_size": 4, "router_policy": "prefix-affinity"}),
    ("prefix-heavy", "disagg", {"page_size": 4, "disagg_prefill": 1, "disagg_decode": 1}),
]


@pytest.mark.parametrize("scenario, backend, knobs", PARITY,
                         ids=[f"{s}-{b}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for s, b, kw in PARITY])
def test_cell_equals_the_jax_packages(bundles, scenario, backend, knobs):
    """Every key but ``wall_time_s``: attainment per tenant and class,
    goodput, shed and cancelled counts, the ``kv``/``router``/``disagg``/
    ``churn`` blocks, the paged variant, and (``trace=""`` with a
    ``slo_window``, unless the case turns tracing off) the trace block."""
    jb, tb = bundles
    knobs = {"trace": "", "slo_window": 0.01, **knobs}
    if knobs["trace"] is None:
        knobs["slo_window"] = None
    a = jax_harness.evaluate_cell(scenario, "kairos-urgency", "kairos-slack", backend,
                                  jax_harness.HarnessConfig(n_requests=N, **knobs), _bundle=jb)
    b = evaluate_cell(scenario, "kairos-urgency", "kairos-slack", backend,
                      HarnessConfig(n_requests=N, **knobs), _bundle=tb, device="cpu")
    assert _cells({"cells": [b]}) == _cells({"cells": [a]})
    assert b["n_completed"] + b["shed"]["total"] + b["cancelled"]["total"] == N
    if knobs["trace"] is not None:
        assert b["trace"]["events"] > 0 and b["trace"]["slo"]
    if backend == "churn":  # the kill caught requests, queued ones at this size
        [rec] = b["churn"]["fleet"]["recoveries"]
        assert rec["replica"] == 1 and rec["restored"] + rec["rescheduled"]
    if knobs.get("page_size"):  # real prefix reuse
        assert b["variant"] == "paged"
        hits = b["router"]["prefix"] if backend == "router" else b["kv"]
        assert hits["hit_tokens" if backend == "router" else "prefix_cached_tokens"] > 0


def test_grid_report_equals_the_jax_packages(bundles):
    """The grid envelope: cartesian order, the ``config`` block (which
    carries no device) and the cells, on two prefill policies."""
    jb, tb = bundles
    args = (["paper-longtail"], ["kairos-urgency", "fcfs"], ["kairos-slack"], ["sim", "engine"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_harness, "_EngineBundle", lambda arch: jb)
        a = jax_harness.run_grid(*args, jax_harness.HarnessConfig(n_requests=6))
    b = run_grid(*args, HarnessConfig(n_requests=6), device="cpu", bundle=tb)
    assert b["grid"] == a["grid"] and b["config"] == a["config"]
    assert _cells(b) == _cells(a)


# -------------------------------------------------------------------- CLIs
@pytest.fixture
def cli_bundles(bundles, monkeypatch):
    """Both CLIs build their bundle by arch; hand them the bridged pair."""
    jb, tb = bundles
    monkeypatch.setattr(jax_harness, "_EngineBundle", lambda arch: jb)
    monkeypatch.setattr(jax_loadgen_mod, "_EngineBundle", lambda arch: jb)
    monkeypatch.setattr(harness, "_EngineBundle", lambda arch, device: tb)
    monkeypatch.setattr(loadgen_mod, "_EngineBundle", lambda arch, device: tb)


def test_evaluate_cli_emits_the_jax_packages_json(cli_bundles, tmp_path):
    argv = ["--scenario", "multi-tenant", "--backend", "sim", "engine", "churn",
            "--prefill", "kairos-urgency", "--decode", "kairos-slack-greedy", "--n", "10",
            "--seed", "1", "--kill", "0.009:1", "--autoscaler", "queue-threshold",
            "--replicas", "2", "--trace", "", "--slo-window", "0.01"]
    jax_evaluate_main([*argv, "--out", str(tmp_path / "jax.json")])
    evaluate_main([*argv, "--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "torch.json"))
    assert b["config"] == a["config"] and b["grid"] == a["grid"]
    assert _cells(b) == _cells(a) and len(b["cells"]) == 3


@pytest.mark.parametrize("extra", [
    [],
    ["--pools", "2:1", "--deflect", "slack-aware"],
    ["--servers", "2", "--router", "prefix-affinity", "--page-size", "4"],
], ids=["async-engine", "disagg-2P1D", "router-paged"])
def test_loadgen_cli_emits_the_jax_packages_json(cli_bundles, tmp_path, extra):
    argv = ["--scenario", "prefix-heavy", "--n", "10", "--clients", "3", *extra]
    jax_loadgen_mod.main([*argv, "--out", str(tmp_path / "jax.json")])
    loadgen_mod.main([*argv, "--out", str(tmp_path / "torch.json"), "--device", "cpu"])
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("jax.json", "torch.json"))
    assert b["config"] == a["config"] and b["grid"] == a["grid"]
    assert _cells(b) == _cells(a)
    assert sum(b["cells"][0]["loadgen"]["tokens_by_client"]) > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: cuda is a valid device")
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    for call in (
        lambda: evaluate_main(["--backend", "sim", "--n", "4"]),
        lambda: loadgen_mod.main(["--n", "4"]),
        lambda: evaluate_cell("paper-longtail", "fcfs", "continuous", "sim"),
        lambda: run_grid(["paper-longtail"], ["fcfs"], ["continuous"]),
        lambda: loadgen_mod.run_loadgen("paper-longtail", "fcfs", "continuous",
                                        HarnessConfig(n_requests=4)),
        lambda: _EngineBundle("llama3-8b-smoke").build(),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ------------------------------------------------------------------- twins
def test_engine_scale_mapping_preserves_labels_and_budget(bundles):
    _, tb = bundles
    reqs = generate_scenario("multi-tenant", seed=3, n_requests=40)
    hcfg = HarnessConfig(seed=3)
    pairs = to_engine_requests(reqs, hcfg, tb.cfg.vocab_size, np.random.default_rng(0))
    for orig, (twin, prompt) in zip(reqs, pairs, strict=True):
        assert twin.input_len == len(prompt)
        assert 2 <= twin.input_len <= hcfg.engine_max_prompt
        assert 1 <= twin.output_len <= hcfg.engine_max_output
        assert (twin.tenant, twin.slo_class) == (orig.tenant, orig.slo_class)
        assert twin.slo.ttft == pytest.approx(orig.slo.ttft * hcfg.slo_ttft_scale)
        assert twin.slo.tpot == pytest.approx(orig.slo.tpot * hcfg.engine_slo_tpot_scale)
    longest = max(reqs, key=lambda r: r.input_len)
    assert pairs[longest.rid][0].input_len == hcfg.engine_max_prompt


def test_quota_sheds_per_tenant_and_every_backend_shares_one_schema(bundles):
    _, tb = bundles
    cell = evaluate_cell("multi-tenant", "kairos-urgency", "kairos-slack-greedy", "engine",
                         HarnessConfig(n_requests=16, seed=1, tenant_quota=1,
                                       engine_arrival_scale=1e-4),
                         _bundle=tb, device="cpu")
    assert cell["shed"]["total"] > 0 and cell["shed"]["by_tenant"]
    assert sum(cell["shed"]["by_tenant"].values()) == cell["shed"]["total"]
    assert cell["n_completed"] + cell["shed"]["total"] == cell["n_requests"]
    for tenant, n_shed in cell["shed"]["by_tenant"].items():
        assert cell["per_tenant"][tenant]["n_shed"] == n_shed
    extra = {"sim": set(), "engine": set(), "async-engine": set(), "router": {"router"},
             "disagg": {"disagg"}, "churn": {"churn"}}
    assert set(extra) == set(BACKENDS)
    for backend in BACKENDS:
        c = evaluate_cell("paper-longtail", "fcfs", "continuous", backend,
                          HarnessConfig(n_requests=6, disagg_prefill=1, disagg_decode=1),
                          _bundle=tb, device="cpu")
        assert set(c) == CELL_KEYS | extra[backend], backend
        assert all(r is not None for r in (c["attainment"]["e2e"], c["goodput"]))


def test_parse_kills_and_pools_validate():
    assert parse_kills(["0.5:1", "0.1:0"]) == ((0.1, 0), (0.5, 1))
    with pytest.raises(ValueError, match="T:IDX"):
        parse_kills(["nope"])
    with pytest.raises(ValueError, match=">= 0"):
        parse_kills(["1.0:-2"])
    assert parse_pools("2:3") == (2, 3)
    with pytest.raises(ValueError, match="P:D"):
        parse_pools("2")
    with pytest.raises(ValueError, match=">= 1"):
        parse_pools("0:1")


def test_unknown_backend_and_replay_without_a_trace(capsys):
    with pytest.raises(ValueError, match="backend"):
        evaluate_cell("paper-longtail", "fcfs", "continuous", "gpu-cluster", device="cpu")
    for main in (evaluate_main, loadgen_mod.main):
        with pytest.raises(SystemExit):
            main(["--scenario", "replay", "--device", "cpu"])
        assert "--replay-trace" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        loadgen_mod.main(["--pools", "1:1", "--servers", "2", "--device", "cpu"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_bundle_validates_what_it_is_given(bundles):
    _, tb = bundles
    with pytest.raises(ValueError, match="both"):
        _EngineBundle("llama3-8b-smoke", device="cpu", model=tb.model).build()
    with pytest.raises(ValueError, match="llama3-8b-smoke"):
        _EngineBundle("llama3-8b", device="cpu", model=tb.model, params=tb.params).build()
    built = _EngineBundle("llama3-8b-smoke", device="cpu").build()
    assert built.cfg.dtype == "float32" and built.params["embed"].dtype == torch.float32
    assert built.params["embed"].device.type == "cpu"


def test_replay_cell_round_trips_a_saved_trace(bundles, tmp_path):
    from repro_torch.sim.trace import save_trace

    _, tb = bundles
    path = tmp_path / "trace.jsonl"
    save_trace(str(path), generate_scenario("multi-tenant", seed=4, n_requests=12))
    out = tmp_path / "replay.json"
    evaluate_main(["--scenario", "replay", "--replay-trace", str(path), "--backend", "sim",
                   "--prefill", "fcfs", "--decode", "continuous", "--out", str(out),
                   "--device", "cpu"])
    [cell] = json.loads(out.read_text())["cells"]
    assert cell["scenario"] == "replay" and cell["n_requests"] == 12
    assert set(cell["per_tenant"]) == {"interactive", "standard", "batch"}
