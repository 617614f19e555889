"""Share of the device's busy time spent in kernels launched inside the
harness's ``attention`` spans (``models.flash.flash_attention``), in %."""


def read(rec):
    t = rec.trace
    if not t or not t.get("events") or rec.attention_s is None \
            or t["busy_s"] <= 0:
        return None
    return 100.0 * rec.attention_s / t["busy_s"]
