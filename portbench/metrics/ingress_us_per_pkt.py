"""Host ingress time per packet: the window less the spans of ``extract``
and ``run_features``, over the packets sent (microseconds per packet)."""


def read(rec):
    if not rec.win["sent"]:
        return None
    rest = (rec.window_s - rec.spans.totals.get("extract", 0.0)
            - rec.spans.totals.get("engine", 0.0))
    return rest / rec.win["sent"] * 1e6
