"""Share of the window the host spent retiring batches (egress encode,
result writes, cache insert) and resolving chunks: the program's
``ingress_retire_seconds_total`` (self time, summed over shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_retire_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
