"""Slots visited per probed key in the ingress result cache and pending
window, lookups and inserts together: the program's
``cache_probe_slots_total`` over ``cache_probe_keys_total`` (summed over
shards and both tables), in slots/key."""


def read(rec):
    keys = rec.counters.get("cache_probe_keys_total", 0.0)
    if keys <= 0:
        return None
    return rec.counters.get("cache_probe_slots_total", 0.0) / keys
