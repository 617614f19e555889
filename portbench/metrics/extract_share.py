"""Share of the window inside ``FlowFrontend.extract`` (the harness's span
around each call: host parse, flow table, register-file round trip, flow
kernel), in %."""


def read(rec):
    if not rec.spans.counts.get("extract"):
        return None
    return 100.0 * rec.spans.totals["extract"] / rec.window_s
