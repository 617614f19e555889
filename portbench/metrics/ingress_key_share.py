"""Share of the window the host spent building the wire-row keys (the pad
and feature-count check, or the feature path's encode; packing and
hashing): the program's ``ingress_key_seconds_total`` (self time, summed
over shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_key_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
