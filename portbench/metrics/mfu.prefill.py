"""The whole prefill's share of the card's peak: the model's operations of
every call completed in the window, each at its own peak rate
(``work_lm.ideal_call_s``: the W8A8 GEMMs at the int8 rate, attention and
the unembedding at the bf16 rate), over the window's seconds, in %."""

from portbench import work_lm


def read(rec):
    if rec.calls <= 0:
        return None
    ideal = work_lm.ideal_call_s(rec.sizes, rec.batch, rec.seq) * rec.calls
    return 100.0 * ideal / rec.window_s
