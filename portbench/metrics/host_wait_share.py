"""Share of the window the host spent blocked on a batch's completion: the
program's ``ingress_wait_seconds_total`` (self time, summed over
shards), in %."""


def read(rec):
    v = rec.counters.get("ingress_wait_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
