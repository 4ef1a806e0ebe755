"""The kernel probe (utils/kernel_probe, the port of tools/kernel_probe.py)
at tiny sizes on the CPU, and the fit that sets the full-row ``auto``
rule's constants.

``main`` with ``--device cpu`` runs the probe's measurements and the
``--sweep auto`` sweep through the kernels' plain versions; the records
must carry their schema (the times here are CPU times of the plain
versions, not device numbers). The fit must recover known constants from
a synthetic timing table made by the model itself.
"""

import argparse
import json
import math

import numpy as np
import pytest

from tmgcn_torch.ops import spmm as tspmm
from tmgcn_torch.utils import kernel_probe as kp

TINY = ["--device", "cpu", "--nnz", "2048", "--nodes", "256", "--slices", "2", "--feat", "8",
        "--reps", "1"]
TIMES = {"ms", "best_ms", "max_ms", "spread", "reps"}


def _printed(capsys) -> list:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_probe_main_on_the_cpu(capsys, tmp_path):
    out = kp.main(TINY + ["--out", str(tmp_path / "probe.json")])
    printed = _printed(capsys)
    assert printed[0] == {"device": "cpu", "card": None}
    assert json.loads((tmp_path / "probe.json").read_text()) == json.loads(json.dumps(out))
    names = set(kp.VARIANTS)
    for n in ("pallas_f32_256", "pallas_bf16_256", "pallas_tiled_bf16", "pallas_tiled_f32"):
        names |= {n + "_kernel_only", n + "_gather_only"}
    names |= {"clustered_pallas_bf16", "clustered_pallas_tiled_bf16", "clustered_blockdense",
              "clustered_blockdense_bf16"}
    assert set(out["variants"]) == names
    for rec in out["variants"].values():
        assert set(rec) == TIMES | {"mnnz_per_s", "roofline_frac", "gather_bound_frac"}
        assert rec["ms"] > 0 and rec["mnnz_per_s"] > 0
    assert [p["variant"] for p in printed if "variant" in p] == list(out["variants"])
    assert (out["T"], out["N"], out["F"]) == (2, 256, 8) and out["nnz"] > 0
    assert out["roofline_ms"] > 0 and out["gather_bound_ms"] > 0
    assert out["blockdense_clustered_ratio"] > 0 and out["blockdense_random_ratio"] > 0


def test_sweep_main_on_the_cpu(capsys, tmp_path):
    out = kp.main(TINY + ["--sweep", "auto", "--shapes", "banded,random",
                          "--out", str(tmp_path / "sweep.json")])
    printed = _printed(capsys)
    names = [f"{p}_{i}_F8" for i in range(3) for p in ("banded", "random")]
    assert [r["shape"] for r in out["records"]] == names
    assert [p["shape"] for p in printed if "shape" in p] == names
    assert printed[-1] == json.loads(json.dumps({"fitted": out["fitted"],
                                                 "committed": out["committed"]}))
    for rec in out["records"]:
        assert set(rec) >= {"T", "N", "F", "nnz", "counts", "bound_ms", "ops",
                            "blockdense_ratio", "picks", "seconds"}
        assert set(rec["counts"]) == {"f32", "bf16"}
        assert set(rec["counts"]["f32"]) == {"nnz", "sectors", "tile_sectors", "k1_chunks",
                                             "k3_chunks", "k3_tiles", "blockdense_ratio"}
        assert rec["counts"]["bf16"]["tile_sectors"] == rec["counts"]["f32"]["tile_sectors"] // 2
        assert set(rec["ops"]) == set(kp.CANDIDATES)
        for op in rec["ops"].values():
            assert set(op) == {"fwd", "fwdbwd", "max_abs_err"}
            assert set(op["fwd"]) == set(op["fwdbwd"]) == TIMES
        for cls in ("f32", "bf16"):
            picks = rec["picks"][cls]
            assert set(picks) == {"tiled_ratio", "committed", "fitted", "fastest"}
            assert {picks[k] for k in ("committed", "fitted", "fastest")} <= {
                "blockdense", "tiled", "windowed"}
    assert set(out["fitted"]) == {"AUTO_BLOCKDENSE_RATIO", "AUTO_TILED_RATIO", "AUTO_K1_COSTS",
                                  "AUTO_K3_COSTS"}
    assert out["committed"]["AUTO_TILED_RATIO"] == tspmm.AUTO_TILED_RATIO
    assert not kp.WORK_DIR.exists()


def test_sweep_shapes_at_the_defaults():
    args = argparse.Namespace(nnz=1 << 20, slices=16, nodes=8192, feat=128)
    assert list(kp.sweep_shapes(args)) == [
        "chess_train_F2", "chess_train_F6", "uci_layer2_F6", "seir_propagation_F5",
        "spmm_bench_r1_F128", "spmm_bench_chess2_F8",
        "banded_0_F128", "random_0_F128", "banded_1_F128", "random_1_F128",
        "banded_2_F128", "random_2_F128",
    ]


K1 = {"launch": 0.008, "entry": 3e-7, "chunk": 2e-5, "gather": 4e-8}
K3 = {"launch": 0.011, "entry": 5e-7, "chunk": 4e-5, "gather": 9e-7}


def _synthetic_counts(n: int = 12, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"nnz": int(rng.integers(1e4, 5e6)), "sectors": (s := int(rng.choice([1, 4, 16]))),
             "tile_sectors": 8 * s,
             "k1_chunks": int(rng.integers(50, 20_000)), "k3_chunks": int(rng.integers(50, 40_000)),
             "k3_tiles": int(rng.integers(1e3, 1e6)),
             "blockdense_ratio": float(rng.uniform(0.01, 20))} for _ in range(n)]


@pytest.mark.parametrize("kernel,costs", [("k1", K1), ("k3", K3)])
def test_fit_costs_recovers_the_model(kernel, costs):
    samples = [(c, tspmm.model_ms(c, kernel, costs)) for c in _synthetic_counts()]
    got = kp.fit_costs(samples, kernel)
    for k, v in costs.items():
        assert math.isclose(got[k], v, rel_tol=1e-6, abs_tol=1e-12), (k, got[k], v)


def test_fit_limit_is_the_largest_safe_limit():
    # Measured ratio = 3 x predictor, and one shape 5 x: limit 1/5.
    pts = [(p, 3 * p) for p in (0.01, 0.1, 0.5)] + [(0.2, 1.0)]
    assert math.isclose(kp.fit_limit(pts), 0.2)
    assert kp.fit_limit([]) == 0.0
    limit = kp.fit_limit(pts)
    assert all(r < 1 for p, r in pts if p < limit)


def test_fit_recovers_constants_from_a_synthetic_table():
    """Records whose K1 and K3 times follow the model exactly (float32 and
    bf16 alike) and whose block-dense times are 4x K1's times the
    estimate's ratio: the costs come back, the tiled limit is 1 (the model
    is exact) and the block-dense limit 1/4."""
    records = []
    for c in _synthetic_counts(16, seed=3):
        half = {k: max(1, c[k] // 2) for k in ("sectors", "tile_sectors")}
        rec = {"counts": {"f32": c, "bf16": {**c, **half}},
               "blockdense_ratio": c["blockdense_ratio"], "ops": {}}
        for cls, sfx in (("f32", ""), ("bf16", "_bf16")):
            t1 = tspmm.model_ms(rec["counts"][cls], "k1", K1)
            t3 = tspmm.model_ms(rec["counts"][cls], "k3", K3)
            rec["ops"]["k1" + sfx] = {"fwdbwd": {"ms": t1}}
            rec["ops"]["k3" + sfx] = {"fwdbwd": {"ms": t3}}
            rec["ops"]["blockdense" + sfx] = {"fwdbwd": {"ms": 4 * c["blockdense_ratio"] * t1}}
        records.append(rec)
    fitted = kp.fit(records)
    for got, want in ((fitted["AUTO_K1_COSTS"], K1), (fitted["AUTO_K3_COSTS"], K3)):
        for k in want:
            assert math.isclose(got[k], want[k], rel_tol=1e-6, abs_tol=1e-12), k
    assert math.isclose(fitted["AUTO_TILED_RATIO"], 1.0, rel_tol=1e-6)
    assert math.isclose(fitted["AUTO_BLOCKDENSE_RATIO"], 0.25, rel_tol=1e-9)
    picks = kp.picks(records[0], fitted)
    assert picks["f32"]["fastest"] in ("blockdense", "tiled", "windowed")
    # An over-budget block-dense (no time) leaves its shape out of the fit.
    records[0]["ops"]["blockdense"] = {"error": "over budget"}
    assert math.isclose(kp.fit(records)["AUTO_BLOCKDENSE_RATIO"], 0.25, rel_tol=1e-9)
