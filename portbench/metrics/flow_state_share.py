"""Share of the window the host spent in the flow update
(``FlowFrontend._update``: on the card the register file's and the
sketch's round trip and the flow kernel): the program's
``flow_state_seconds_total`` (self time, summed over shards), in %."""


def read(rec):
    v = rec.counters.get("flow_state_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
