"""Share of the window the host spent in the flow frontend's own host
stages: the program's ``flow_parse_seconds_total`` (raw-row validation
and header parse), ``flow_table_seconds_total`` (key packing, flow-table
lookup and insert, sketch cells) and ``flow_gather_seconds_total`` (the
FeatureSpec gather), summed, in %."""

STAGES = ("flow_parse", "flow_table", "flow_gather")


def read(rec):
    v = [rec.counters.get(f"{s}_seconds_total") for s in STAGES]
    return None if None in v else 100.0 * sum(v) / rec.window_s
