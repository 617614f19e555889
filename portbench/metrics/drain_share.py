"""Share of the window the host spent in the drain's result assembly and
ticket reset, after its flush: the program's
``ingress_drain_seconds_total`` (self time, summed over shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_drain_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
