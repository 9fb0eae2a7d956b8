"""Device time of a decode step's KV copies: the ``device_s`` of its
``decode.gather`` (the bucket's lanes gathered out of the page pool) and
``decode.scatter`` (the new rows written back) spans summed, averaged over
the steps that ended in the window; milliseconds. Traced run on the card."""
from kbench.record import engine_calls

COPIES = ("decode.gather", "decode.scatter")


def read(rec):
    per_step = []
    for call in engine_calls(rec, "decode"):
        dev = [s[4] for s in call if s[0] in COPIES]
        if len(dev) == len(COPIES) and None not in dev:
            per_step.append(sum(dev))
    return 1e3 * sum(per_step) / len(per_step) if per_step else None
