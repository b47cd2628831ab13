"""Process start to the first timed request: imports, the CUDA context,
the kernel libraries (built on a checkout's first run), the weights made
on the card, the longest prompt's prefill and the primed requests."""


def read(rec):
    return rec.setup_s
