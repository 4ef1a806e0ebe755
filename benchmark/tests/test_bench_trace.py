"""The idle share is one minus the union of device intervals over the
window; the breakdown names the longest operations and gaps."""

import importlib.util

from benchmark import harness, trace
from benchmark.trace import Trace


def _synthetic():
    # Window 0..100 us. Device: 10-30 and 20-40 overlap (union 10-40),
    # 50-60, and 95-120 sticks out of the window (counts 95-100).
    dev = [("k1", 10.0, 30.0), ("k2", 20.0, 40.0), ("k1", 50.0, 60.0), ("k3", 95.0, 120.0)]
    host = [("bench.window", 0.0, 100.0), ("aten::to", 40.0, 50.0), ("numpy scoring", 60.0, 95.0),
            ("aten::mm", 65.0, 70.0)]
    return Trace((0.0, 100.0), dev, host, steps=2)


def test_union_of_intervals():
    assert trace.union([(3, 5), (1, 2), (2, 4), (7, 7), (6, 8)]) == [(1, 5), (6, 8)]


def test_busy_and_idle_share():
    tr = _synthetic()
    assert abs(trace.busy_s(tr) - 45e-6) < 1e-12  # 30 + 10 + 5 us
    ctx = harness.Context(cfg={}, n_classes=2, spans={}, eval_every=1, boundaries=[], trace=tr)
    read = harness.metric_reader("device.idle_share")
    assert abs(read(ctx) - 55.0) < 1e-9
    assert trace.idle_gaps(tr) == [(0.0, 10.0), (40.0, 50.0), (60.0, 95.0)]


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(_synthetic())
    assert [n for n, _ in b["device_ops"]] == ["k1", "k2", "k3"]
    assert abs(b["device_ops"][0][1] - 30e-6) < 1e-12
    # The longest gap, 60-95, is named by the host operation covering its middle.
    assert b["idle_gaps"][0][0] == "numpy scoring" and abs(b["idle_gaps"][0][1] - 35e-6) < 1e-12
    assert sorted(n for n, _ in b["idle_gaps"][1:]) == ["aten::to", "host (no traced operation)"]


def test_no_trace_no_reading():
    ctx = harness.Context(cfg={}, n_classes=2, spans={}, eval_every=1, boundaries=[])
    for name in ("device.idle_share", "layer2_spmm_roofline", "readout_scatter_roofline",
                 "step_mfu", "loop.plain_epoch_ms", "loop.eval_overhead_ms",
                 "step_mfu.recurrent", "loop.plain_epoch_ms.recurrent"):
        assert harness.metric_reader(name)(ctx) is None


def test_roofline_needs_one_launch_per_product():
    tr = _synthetic()
    dev = [("void row_segment::row_segment_matmul_kernel<6, false, false, tier::F32>(int)",
            10.0 * i, 10.0 * i + 4.0) for i in range(4)]
    tr = Trace((0.0, 100.0), dev, tr.host_ops, steps=2)
    spec = importlib.util.spec_from_file_location("c", harness.BENCH / "cost" / "tmgcn2.py")
    cost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cost)
    counts = {"edges": 10, "ends": 8, "nnz": 40, "used": 20, "f0": 2}
    cfg = {"hidden_feat": [6, 6]}
    ctx = harness.Context(cfg=cfg, n_classes=2, spans={}, eval_every=1, boundaries=[], trace=tr,
                          cost=cost, counts=counts)
    read = harness.metric_reader("layer2_spmm_roofline")
    least = 2 * sum(p.least_s for p in cost.kernel_products(counts, cfg))
    assert abs(read(ctx) - 100 * least / 16e-6) < 1e-9
    ctx.trace = Trace((0.0, 100.0), dev[:3], tr.host_ops, steps=2)  # a launch short
    assert read(ctx) is None


def test_eval_overhead_from_block_walls():
    # Blocks of 10 epochs at 1 ms a plain epoch: the first block (epoch 0 to
    # 10) captures and is left out; a block of another trial's boundaries or
    # of another length is no block.
    b = [(0, 0, 0.0), (0, 10, 0.5), (0, 20, 0.512), (0, 30, 0.526), (1, 40, 0.6), (1, 45, 0.61)]
    ctx = harness.Context(cfg={}, n_classes=2, spans={}, eval_every=10, boundaries=b,
                          plain_epoch_s=1e-3)
    read = harness.metric_reader("loop.eval_overhead_ms")
    assert abs(read(ctx) - 3.0) < 1e-9  # walls 12 and 14 ms, less 10 ms
