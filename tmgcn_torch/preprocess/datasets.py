"""Dataset registry: the nine reference datasets plus synthetics.

Capability reference: the per-dataset configuration blocks of IBM/TM-GCN
TensorGCN-master/read_data.m:13-103 (splits, time_delta, file format) and
full_read_data.py:49-57 (AMLSim column mapping). Raw files are external
downloads (KONECT/SNAP); only Chess ships in-repo (data/chess/). Each
entry records how to parse the raw file and the canonical preprocessing
config; ``load_raw`` + ``tmgcn_torch.preprocess.pipeline.preprocess`` turn
a raw file into the framework's artifact.

Port of tmgcn_tpu.preprocess.datasets: the same registry; ``load_raw``
parses with the native host runtime's parser (``tmgcn_torch.native``), as
the JAX package does wherever its library loads; ``parse_edges_numpy`` is
its plain version (``np.loadtxt``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from tmgcn_torch import native
from tmgcn_torch.preprocess.pipeline import PreprocessConfig, RawEdges, bin_edges

DAY = 60.0 * 60 * 24


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    filename: str
    delimiter: str | None  # None -> whitespace
    skiprows: int
    columns: tuple[int, int, int, int]  # src, dst, weight, timestamp
    preprocess: PreprocessConfig
    n_classes: int = 2
    comments: str = "#"


REGISTRY: dict[str, DatasetSpec] = {
    "bitcoin_otc": DatasetSpec(
        name="bitcoin_otc",
        filename="soc-sign-bitcoinotc.csv",
        delimiter=",",
        skiprows=0,
        columns=(0, 1, 2, 3),
        preprocess=PreprocessConfig(95, 20, 20, time_delta=14 * DAY),
    ),
    "bitcoin_alpha": DatasetSpec(
        name="bitcoin_alpha",
        filename="soc-sign-bitcoinalpha.csv",
        delimiter=",",
        skiprows=0,
        columns=(0, 1, 2, 3),
        preprocess=PreprocessConfig(95, 20, 20, time_delta=14 * DAY),
    ),
    "reddit": DatasetSpec(
        name="reddit",
        filename="soc-redditHyperlinks-body.tsv",
        delimiter="\t",
        skiprows=1,
        columns=(0, 1, 4, 3),
        preprocess=PreprocessConfig(66, 10, 10, time_delta=14 * DAY),
    ),
    "chess": DatasetSpec(
        name="chess",
        filename="out.chess.csv",
        delimiter=None,
        skiprows=1,
        columns=(0, 1, 2, 3),
        preprocess=PreprocessConfig(80, 10, 10, time_delta=None),
        n_classes=3,
        comments="%",
    ),
    "hep_th": DatasetSpec(
        name="hep_th",
        filename="out.ca-cit-HepTh",
        delimiter=None,
        skiprows=1,
        columns=(0, 1, 2, 3),
        preprocess=PreprocessConfig(155, 20, 20, time_delta=60 * DAY),
        comments="%",
    ),
    "wikiconflict": DatasetSpec(
        name="wikiconflict",
        filename="out.wikiconflict",
        delimiter=None,
        skiprows=1,
        columns=(0, 1, 2, 3),
        preprocess=PreprocessConfig(
            69, 10, 10, time_delta=31 * DAY, min_column_sum=100.0
        ),
        comments="%",
    ),
    "amlsim": DatasetSpec(
        name="amlsim",
        filename="transactions.csv",
        delimiter=",",
        skiprows=1,
        columns=(1, 2, 7, 5),
        preprocess=PreprocessConfig(150, 25, 25, time_delta=None),
    ),
    "uci": DatasetSpec(
        name="uci",
        filename="OCnodeslinks.txt",
        delimiter=None,
        skiprows=0,
        columns=(1, 2, 3, 0),
        preprocess=PreprocessConfig(62, 13, 13, time_delta=1.0),
    ),
    "eu_core": DatasetSpec(
        name="eu_core",
        filename="email-Eu-core-temporal.txt",
        delimiter=None,
        skiprows=0,
        columns=(0, 1, 2, 2),
        preprocess=PreprocessConfig(93, 20, 20, time_delta=6 * DAY),
    ),
}


def parse_edges_numpy(
    path: str | Path, columns, delimiter: str | None, skiprows: int, comment: str
) -> np.ndarray:
    """The plain version of ``native.parse_edges``: ``np.loadtxt``'s selected
    columns, (n_rows, len(columns)) float64."""
    data = np.loadtxt(path, delimiter=delimiter, skiprows=skiprows, comments=comment, ndmin=2)
    return data[:, list(columns)]


def load_raw(
    spec: DatasetSpec, data_dir: str | Path, n_slices_cap: int | None = None
) -> RawEdges:
    """Parse a dataset's raw file into binned edges (the native runtime's
    parser, which raises if it does not build)."""
    path = Path(data_dir) / spec.filename
    s, d, w, t = native.parse_edges(
        path, spec.columns, spec.delimiter, spec.skiprows, spec.comments
    ).T
    one_based = s.min() >= 1 and d.min() >= 1
    return bin_edges(
        s, d, w, t, spec.preprocess.time_delta, n_slices_cap, one_based_nodes=one_based
    )
