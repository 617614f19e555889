"""Share of the device's busy time spent in kernels launched inside the
program's ``moe.route``, ``moe.dispatch`` and ``moe.combine`` ranges (the
router, the sort by expert and gather, the weighted sum back), in %."""


def read(rec):
    t, ranges = rec.trace, getattr(rec, "ranges", None)
    if not t or not t.get("events") or not ranges or t["busy_s"] <= 0:
        return None
    s = sum(ranges.get(k, 0.0) for k in ("moe.route", "moe.dispatch",
                                         "moe.combine"))
    return 100.0 * s / t["busy_s"] if s > 0 else None
