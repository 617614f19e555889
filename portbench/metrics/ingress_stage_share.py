"""Share of the window the host spent staging the fresh rows (their parse,
admission, chunk records, the pending insert and the staging copies):
the program's ``ingress_stage_seconds_total`` (self time, summed over
shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_stage_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
