"""Share of the window the host spent dispatching device batches
(``run_features``' copies to the device, its launches and the queued
copy back, with retries): the program's
``engine_dispatch_seconds_total`` (self time, summed over shards), in %."""


def read(rec):
    v = rec.counters.get("engine_dispatch_seconds_total")
    return None if v is None else 100.0 * v / rec.window_s
