"""Seconds of the port's adapter build (``tasks.adapters.make_edge_adapter``:
packing, readout plans, the cached propagation, the restricted layer 2 and
the operator the ``auto`` rule picks), ending in a synchronise. A span of
the benchmark around the call."""


def read(ctx):
    return ctx.spans.get("setup.adapter")
