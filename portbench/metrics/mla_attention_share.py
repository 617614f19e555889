"""Share of the device's busy time spent in kernels launched inside the
program's ``mla.attend`` ranges (MLA's causal attention, the flash form
at these lengths), in %."""


def read(rec):
    t, ranges = rec.trace, getattr(rec, "ranges", None)
    if not t or not t.get("events") or not ranges or t["busy_s"] <= 0:
        return None
    s = ranges.get("mla.attend", 0.0)
    return 100.0 * s / t["busy_s"] if s > 0 else None
