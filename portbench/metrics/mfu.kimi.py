"""The whole Kimi Linear prefill's share of the card's bf16 peak: the FLOP
of every call completed in the window, from the published widths
(``work_kimi_linear.call_flop``), over the window's seconds and 989.4e12
FLOP/s, in %."""

from portbench import work_kimi_linear
from portbench.work_lm import BF16_FLOP_PER_S


def read(rec):
    if getattr(rec, "calls", 0) <= 0 or not getattr(rec, "sizes", None):
        return None
    flop = work_kimi_linear.call_flop(rec.sizes, rec.batch, rec.seq) \
        * rec.calls
    return 100.0 * flop / rec.window_s / BF16_FLOP_PER_S
