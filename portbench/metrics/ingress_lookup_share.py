"""Share of the window the host spent in the result-cache lookup and hit
fill, the in-chunk dedup and the pending-window lookup: the program's
``ingress_lookup_seconds_total`` (self time, summed over shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_lookup_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
