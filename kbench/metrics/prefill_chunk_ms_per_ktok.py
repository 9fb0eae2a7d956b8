"""Device time of the prefill chunks that ended in the window (the
``device_s`` of their ``prefill.chunk`` spans), per 1000 prompt tokens they
computed (the spans' ``take``); milliseconds. Traced run on the card."""
from kbench.record import program_spans


def read(rec):
    sp = [s for s in program_spans(rec, "prefill.chunk") if s[4] is not None]
    tok = sum(s[5]["take"] for s in sp)
    return 1e6 * sum(s[4] for s in sp) / tok if tok else None
