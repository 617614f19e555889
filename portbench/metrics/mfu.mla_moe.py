"""The whole MLA + MoE prefill's share of the card's bf16 peak: the FLOP
of every call completed in the window, from the published widths
(``work_mla_moe.call_flop``), over the window's seconds and 989.4e12
FLOP/s, in %."""

from portbench import work_mla_moe
from portbench.work_lm import BF16_FLOP_PER_S


def read(rec):
    if rec.calls <= 0:
        return None
    flop = work_mla_moe.call_flop(rec.sizes, rec.batch, rec.seq) * rec.calls
    return 100.0 * flop / rec.window_s / BF16_FLOP_PER_S
