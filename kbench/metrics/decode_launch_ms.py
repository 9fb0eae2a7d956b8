"""Host time of a decode step up to its wait: from the start of its
``decode.gather`` span to the start of its ``decode.wait`` (the blocking
copy of the tokens to the host), averaged over the steps that ended in the
window; milliseconds. Where the host issues the step's work more slowly
than the card runs it, this is the step. Traced run."""
from kbench.record import engine_calls


def read(rec):
    per_step = []
    for call in engine_calls(rec, "decode"):
        t = {s[0]: s[2] for s in call}
        if "decode.gather" in t and "decode.wait" in t:
            per_step.append(t["decode.wait"] - t["decode.gather"])
    return 1e3 * sum(per_step) / len(per_step) if per_step else None
