"""The MLP kernel's share of its roofline: the least time the card could
take for the batches the window dispatched (``work.mlp_launch``), summed,
over the kernel's device time in the trace, in %."""

from portbench import work


def read(rec):
    t = rec.trace
    if not t or not t.get("events"):
        return None
    dims = work.mlp_dims(rec.cell.cfg)
    bound = sum(work.bound_s(*work.mlp_launch(mid, dims))
                for fired, mid, _ in rec.batches
                if fired & {"int16", "int8"})
    dev = t["per_kernel"]["mlp"]["seconds"]
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
