"""The forest range kernel's share of its roofline: the least time for the
forest rows the window dispatched (``work.forest_launch``: each row's
paths), summed, over the kernel's device time in the trace, in %."""

from portbench import deploy, work


def read(rec):
    t = rec.trace
    if not t or not t.get("events") or not rec.cell.forests:
        return None
    _, forests_q = deploy.reference_tables({}, rec.cell.forests)
    bound = sum(work.bound_s(*work.forest_launch(fx[0], fx[1], forests_q))
                for fired, _, fx in rec.batches
                if "range" in fired and fx is not None)
    dev = t["per_kernel"]["forest"]["seconds"]
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
