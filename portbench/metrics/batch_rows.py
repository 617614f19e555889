"""Packets served per device batch in the window: the program's
``engine_packets_total`` over its ``ingress_lane_batches_total`` summed
over the lanes (rows)."""


def read(rec):
    b = rec.counters.get("ingress_lane_batches_total", 0.0)
    if b <= 0:
        return None
    return rec.counters.get("engine_packets_total", 0.0) / b
