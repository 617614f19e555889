"""Share of the device's busy time spent in kernels launched inside the
program's ``zamba2.attend`` ranges (the shared blocks' causal attention,
the flash form), in %."""


def read(rec):
    t, ranges = rec.trace, getattr(rec, "ranges", None)
    if not t or not t.get("events") or not ranges or t["busy_s"] <= 0:
        return None
    s = ranges.get("zamba2.attend", 0.0)
    return 100.0 * s / t["busy_s"] if s > 0 else None
