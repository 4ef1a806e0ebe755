"""The work counts, held against sums worked out by hand at two small
chess-like shapes, and the sparse product's bytes read once."""

import importlib.util

import torch

from benchmark import harness
from benchmark.cost import common as c
from benchmark.reference.data import Window


def _cost(name):
    spec = importlib.util.spec_from_file_location(name, harness.BENCH / "cost" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(T, N, entries, edges):
    t, r, col = (torch.tensor(x) for x in zip(*entries))
    e = torch.tensor(edges).T
    return Window(T, N, t * N + r, t * N + col, torch.ones(len(entries)),
                  torch.zeros(T, N, 2), None, e, torch.zeros(e.shape[1], dtype=torch.long),
                  torch.ones(e.shape[1], dtype=torch.bool))


def test_tmgcn2_counts_shape_a():
    # 2 slices x 4 nodes. Edges (t, src, trg): (0, 0, 1), (1, 2, 3):
    # endpoint rows {0, 1, 6, 7}. Entries in those rows: (0,0,0) (0,0,2)
    # (0,1,3) (1,2,1) (1,3,3); the entry (0,2,2) is in no endpoint row.
    w = _window(2, 4, [(0, 0, 0), (0, 0, 2), (0, 1, 3), (0, 2, 2), (1, 2, 1), (1, 3, 3)],
                [(0, 0, 1), (1, 2, 3)])
    n = _cost("tmgcn2").counts(w)
    assert n == {"edges": 2, "ends": 4, "nnz": 5, "used": 5, "f0": 2}


def test_tmgcn2_counts_shape_b_shared_columns():
    # 1 slice x 6 nodes, every entry reads column 5: one used row.
    w = _window(1, 6, [(0, 0, 5), (0, 1, 5), (0, 2, 5), (0, 3, 5)], [(0, 0, 1), (0, 2, 3)])
    n = _cost("tmgcn2").counts(w)
    assert n == {"edges": 2, "ends": 4, "nnz": 4, "used": 1, "f0": 2}
    (fwd, bwd) = _cost("tmgcn2").kernel_products(n, {"hidden_feat": [6, 6]})
    # By hand: 2 words an entry, a pointer a row (4 + 1), 1 used row and
    # 4 output rows of 6 features: (8 + 5 + 6 + 24) words.
    assert fwd.bytes == 4 * (8 + 5 + 6 + 24) and fwd.flops == 2 * 4 * 6
    assert bwd.bytes == 4 * (8 + 2 + 24 + 6)
    # PERF's earlier bound counted a gathered row per entry, nnz * (8 + 4F):
    # above the count that reads each input byte once when entries share rows.
    assert 4 * (8 + 4 * 6) + 4 * 24 > fwd.bytes


def test_wdgcn_counts():
    # Node 0 read at slices 0 and 2, node 1 at 0, node 3 at 2: node-steps
    # (2 + 1) + (0 + 1) + (2 + 1) = 7.
    w = _window(3, 4, [(0, 0, 1)], [(0, 0, 1), (2, 0, 3)])
    n = _cost("wdgcn").counts(w)
    assert n == {"edges": 2, "ends": 4, "node_steps": 7, "rows": 12, "f0": 2}
    (scatter,) = _cost("wdgcn").kernel_products(n, {"hidden_feat": [6]})
    assert scatter.bytes == 4 * (4 * 6 + 4 + 12 * 6)


def test_epoch_ops_least_time():
    n = {"edges": 39192, "ends": 20203, "nnz": 329876, "used": 87089, "f0": 2}
    ops = _cost("tmgcn2").epoch_ops(n, {"hidden_feat": [6, 6]}, 3)
    layer2 = next(op for op in ops if op.name == "layer2")
    assert layer2.flops == 2 * 329876 * 6
    assert layer2.least_s == layer2.bytes / c.PEAK_BYTES_S
    assert c.least_s(ops) == sum(op.least_s for op in ops)
    mm = c.matmul("x", 2, 3, 4)
    assert (mm.flops, mm.bytes) == (48, 4 * (6 + 12 + 8))
