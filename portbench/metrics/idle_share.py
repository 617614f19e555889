"""Share of the traced window in which no operation ran on the device
(the profiler's device timeline), in %."""


def read(rec):
    t = rec.trace
    if not t or not t.get("events"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
