"""Per cent of the card's peak that a whole training epoch reaches: the
least time of the work one epoch needs (``benchmark/cost/<config>.py``
``epoch_ops``: forward, backward and the SGD-momentum update at the cell's
shapes, each operation the larger of its FLOPs at 67 TFLOP/s and its bytes
at 3.35 TB/s) over ``loop.plain_epoch_ms``. The count is the same
whatever operator implements the step."""


def read(ctx):
    if ctx.plain_epoch_s is None or ctx.cost is None:
        return None
    ops = ctx.cost.epoch_ops(ctx.counts, ctx.cfg, ctx.n_classes)
    return 100.0 * sum(op.least_s for op in ops) / ctx.plain_epoch_s
