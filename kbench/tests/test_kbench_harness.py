"""The harness runs a cell that exists only as files in a temporary
directory (a configuration, a traffic mix, an entry), on the CPU at smoke
widths, through the whole run: the drive, the readers, the check."""
import io
import time

import pytest

from kbench.bench import run_cell
from kbench.spec import load_cell

E2E = {"ttft_p50_s", "tpot_p95_ms", "output_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_throwaway_cell_runs(tiny, loop):
    bench, root = tiny(loop=loop)
    cell = load_cell(bench, "tiny.throwaway", root=root)
    log = io.StringIO()
    r = run_cell(cell, 2**31 + 17, 4.0, False, time.monotonic(), device="cpu", log=log)
    assert r["correct"] is True, log.getvalue()
    assert set(r["metrics"]) == E2E
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["widest_logit_gap"]["value"] <= 0.05
    assert log.getvalue().rstrip().splitlines()[-1].startswith("[kbench] compared:")


def test_traced_run_reports_the_layers(tiny):
    bench, root = tiny(loop="closed")
    cell = load_cell(bench, "tiny.throwaway", root=root)
    r = run_cell(cell, 5, 4.0, True, time.monotonic(), device="cpu", log=io.StringIO())
    # no card: the device readers find nothing to read and are left out; the
    # program's spans are in the record, with host times and no device times
    assert {"prefill_queue_p95_s", "decode_batch_mean", "prefill_ms_per_ktok",
            "decode_step_ms", "mfu.prefill", "mfu.decode", "decode_launch_ms"} <= set(r["metrics"])
    assert not {"prefill_attention_roofline", "decode_kv_copy_ms", "prefill_chunk_ms_per_ktok",
                "decode_forward_idle_share", "moe_decode_ms"} & set(r["metrics"])
