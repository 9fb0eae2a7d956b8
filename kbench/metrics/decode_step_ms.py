"""Mean host time of a decode step (gather, step, scatter, sample; it ends
in a copy to the host): ``DECODE_STEP.step_time`` summed over the window
over the steps; milliseconds. Traced run."""


def read(rec):
    t0, t1 = rec["window"]
    st = [s for t, _, s in rec["steps"] if t0 <= t <= t1]
    return 1e3 * sum(st) / len(st) if st else None
