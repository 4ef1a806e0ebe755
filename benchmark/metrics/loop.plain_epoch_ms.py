"""Milliseconds of one plain epoch of the loop's captured step (a replay),
timed in chunks that end in a fetch, rounds of at least 0.25 s, the median
of five (``benchmark.timing.timed_chunks``)."""


def read(ctx):
    return None if ctx.plain_epoch_s is None else 1e3 * ctx.plain_epoch_s
