"""95th percentile, over the requests due in the window, of the wait from
when a request was due to its first prefill chunk (``PREFILL_START``);
one not started by the window's end counts (end - due). Traced run."""
from kbench.record import due_in_window
from kbench.yardstick import percentile


def read(rec):
    if not rec["steps"]:
        return None  # no trace events: not the traced run
    t1 = rec["window"][1]
    vals = []
    for r in due_in_window(rec):
        s = r["prefill_start"]
        vals.append((s if s is not None and s <= t1 else t1) - r["due"])
    return percentile(vals, 95)
