"""KDA's recurrence's share of its roofline: for every KDA layer call in
the window, the larger of its FLOP at the bf16 rate and its bytes at HBM
bandwidth in the chunked form at chunk 64
(``work_kimi_linear.kda_bound_s``), summed, over the device time of the
kernels launched inside the program's ``kda.scan`` ranges, in %."""

from portbench import work_kimi_linear


def read(rec):
    ranges, stats = getattr(rec, "ranges", None), getattr(rec, "kimi", None)
    if not ranges or not stats or stats.get("kda_layers", 0) <= 0 \
            or ranges.get("kda.scan", 0.0) <= 0:
        return None
    bound = work_kimi_linear.kda_bound_s(rec.sizes, rec.batch, rec.seq) \
        * stats["kda_layers"]
    return 100.0 * bound / ranges["kda.scan"]
