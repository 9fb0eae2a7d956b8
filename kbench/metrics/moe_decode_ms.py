"""Device time of the MoE layers in one decode step: the kernel time inside
the ``moe.*`` ranges (route, dispatch, experts, combine) directly inside
the profiled slice's ``decode.forward`` ranges, over the number of those
ranges; milliseconds."""

INSIDE = "decode.forward/moe."


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    ranges = prof["program_ranges"]
    fwd = ranges.get("decode.forward")
    moe = [r["device_s"] for path, r in ranges.items()
           if path.startswith(INSIDE) and "/" not in path[len(INSIDE):]]
    if not fwd or not fwd["count"] or not moe:
        return None
    return 1e3 * sum(moe) / fwd["count"]
