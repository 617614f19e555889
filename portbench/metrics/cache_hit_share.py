"""The ingress result cache's hits over its lookups in the window, from
the program's ``cache_hits_total`` and ``cache_misses_total``, in %."""


def read(rec):
    h = rec.counters.get("cache_hits_total", 0.0)
    m = rec.counters.get("cache_misses_total", 0.0)
    if h + m <= 0:
        return None
    return 100.0 * h / (h + m)
