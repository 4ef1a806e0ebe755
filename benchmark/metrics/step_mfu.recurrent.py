"""``step_mfu``, in the cells whose rate is ``train_edges_per_s.recurrent``."""

from benchmark import harness


def read(ctx):
    return harness.metric_reader("step_mfu")(ctx)
