"""Share of the device's busy time spent in kernels launched inside the
program's ``kda.scan`` ranges (KDA's chunked recurrence), in %."""


def read(rec):
    t, ranges = rec.trace, getattr(rec, "ranges", None)
    if not t or not t.get("events") or not ranges or t["busy_s"] <= 0:
        return None
    s = ranges.get("kda.scan", 0.0)
    return 100.0 * s / t["busy_s"] if s > 0 else None
