"""The routed experts' share of their roofline: for every MoE layer call
in the window, the larger of its experts' FLOP at the bf16 rate and their
bytes (every expert's weights once, the slots' rows in and out) at HBM
bandwidth (``work_mla_moe.expert_bound_s``), summed, over the device time
of the kernels launched inside the program's ``moe.experts`` ranges, in
%."""

from portbench import work_mla_moe


def read(rec):
    ranges, moe = getattr(rec, "ranges", None), getattr(rec, "moe", None)
    if not ranges or not moe or moe["layer_calls"] <= 0 \
            or ranges.get("moe.experts", 0.0) <= 0:
        return None
    slots = moe["slots"] // moe["layer_calls"]
    bound = work_mla_moe.expert_bound_s(rec.sizes, slots) * moe["layer_calls"]
    return 100.0 * bound / ranges["moe.experts"]
