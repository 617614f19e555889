"""The SSD's share of its roofline: for every Mamba layer call in the
window, the larger of its FLOP at the bf16 rate and its bytes at HBM
bandwidth at the published chunk (``work_zamba2.ssd_bound_s``), summed,
over the device time of the kernels launched inside the program's
``ssm.scan`` ranges, in %."""

from portbench import work_zamba2


def read(rec):
    ranges, stats = getattr(rec, "ranges", None), getattr(rec, "zamba2",
                                                          None)
    if not ranges or not stats or stats.get("mamba_layers", 0) <= 0 \
            or ranges.get("ssm.scan", 0.0) <= 0:
        return None
    bound = work_zamba2.ssd_bound_s(rec.sizes, rec.batch, rec.seq) \
        * stats["mamba_layers"]
    return 100.0 * bound / ranges["ssm.scan"]
