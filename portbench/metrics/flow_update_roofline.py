"""The flow-update kernel's share of its roofline: the least time for each
``extract`` call's live packets (``work.flow_launch``: the register rows
and sketch cells they touch), summed, over the device time of the flow
kernel's two device kernels in the trace, in %."""

from portbench import work


def read(rec):
    t = rec.trace
    if not t or not t.get("events") or not rec.extracts:
        return None
    bound = sum(work.bound_s(*work.flow_launch(raw)) for raw in rec.extracts)
    dev = t["per_kernel"]["flow"]["seconds"]
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
