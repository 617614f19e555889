"""The W8A8 GEMM kernel's share of its roofline in the LM prefill: the
least time of every GEMM the window's calls needed
(``work_lm.gemm_bound_s``: operations at the int8 rate or bytes at HBM
bandwidth, whichever is longer), summed, over the kernel's device time in
the trace, in %."""

from portbench import work_lm


def read(rec):
    t = rec.trace
    if not t or not t.get("events"):
        return None
    per_call = sum(work_lm.gemm_bound_s(*g)
                   for g in work_lm.gemms(rec.sizes, rec.batch, rec.seq))
    dev = t["per_kernel"]["gemm"]["seconds"]
    bound = per_call * rec.calls
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
