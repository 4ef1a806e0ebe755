"""Per cent of the roofline that K1 reaches in WD-GCN's readout plan
backward (the scatter of the edge gradients into the node rows, once a
step): the least time of that product (``benchmark/cost/<config>.py``
``kernel_products``) over its device time in the trace
(``trace.kernel_roofline``)."""

from benchmark import trace


def read(ctx):
    return trace.kernel_roofline(ctx)
