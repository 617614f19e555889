"""Device time per batch: the program's
``engine_batch_device_seconds_total`` (each batch timed between its own
events on the card, first copy in to the end of its copy back) over its
``ingress_batches_total``, in microseconds."""


def read(rec):
    d = rec.counters.get("engine_batch_device_seconds_total")
    b = rec.counters.get("ingress_batches_total", 0.0)
    return None if d is None or b <= 0 else d / b * 1e6
