"""Per cent of the roofline that K1 reaches in TM-GCN 2's restricted
layer 2 (its forward and backward products a step): the least time of
those products (``benchmark/cost/<config>.py`` ``kernel_products``,
counted from the cell's inputs) over their device time in the trace
(``trace.kernel_roofline``)."""

from benchmark import trace


def read(ctx):
    return trace.kernel_roofline(ctx)
