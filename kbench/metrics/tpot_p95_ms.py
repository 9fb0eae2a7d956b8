"""95th percentile of the paper's TPOT (the mean gap between a request's
tokens) over every request with two tokens or more received inside the
window, each over its tokens inside the window; milliseconds."""
from kbench.record import tokens_in_window
from kbench.yardstick import percentile


def read(rec):
    vals = []
    for r in rec["rows"]:
        ts = tokens_in_window(r, rec)
        if len(ts) >= 2:
            vals.append(1e3 * (ts[-1] - ts[0]) / (len(ts) - 1))
    return percentile(vals, 95)
