"""Share of the profiled slice in which nothing ran on the device: one
minus the union of the device's activity intervals over the slice's
length; percent."""


def read(rec):
    prof = rec["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
