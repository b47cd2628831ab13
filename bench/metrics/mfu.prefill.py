"""Model FLOPs of every token prefilled and decoded in the traced stretch
(weight products at 2 x parameters, without the embedding lookup, and
the mixing at the published head dims) over the stretch's seconds times
the bf16 peak, in %."""


def read(rec):
    return rec.mfu()
