"""Seconds of the port's data build: ``configs.build.build_data`` (the
preprocessing or its cached artifact), or for a generated graph the port's
``TemporalCOO`` of its slices and ``ops.degree`` features. A span of the
benchmark around the calls."""


def read(ctx):
    return ctx.spans.get("setup.data")
