"""Process start to the window's start: weights, warm-up and the
traffic's lead-in (the first run in a checkout also builds the kernels)."""


def read(rec):
    return rec["setup_s"]
