"""Milliseconds an evaluation adds to its block: each block's wall time
(``eval_every`` epochs between two evaluation epochs' checkpoint calls,
host clock, before the profiler starts) less ``eval_every`` plain epochs
at ``loop.plain_epoch_ms``, averaged over the blocks past a trial's first
(which captures the step). The drive times the plain epochs and these
blocks from the same parameters."""


def read(ctx):
    walls = [b[2] - a[2] for a, b in zip(ctx.boundaries, ctx.boundaries[1:])
             if a[0] == b[0] and a[1] > 0 and b[1] - a[1] == ctx.eval_every]
    if ctx.plain_epoch_s is None or not walls:
        return None
    return 1e3 * (sum(walls) / len(walls) - ctx.eval_every * ctx.plain_epoch_s)
