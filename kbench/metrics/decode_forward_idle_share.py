"""Share of the host's time in the model's decode forward in which the card
had nothing to run: the profiled slice's idle gaps whose midpoint lies in
a ``decode.forward`` range, over those ranges' summed host length;
percent."""


def read(rec):
    prof = rec["profile"]
    fwd = prof["program_ranges"].get("decode.forward") if prof is not None else None
    if not fwd or fwd["host_s"] <= 0:
        return None
    return 100.0 * fwd["idle_s"] / fwd["host_s"]
