"""Share of the window inside ``DataPlaneEngine.run_features`` (the
harness's span around each call: host→device copies, the lane kernels,
the queued copy back), in %."""


def read(rec):
    if not rec.spans.counts.get("engine"):
        return None
    return 100.0 * rec.spans.totals["engine"] / rec.window_s
