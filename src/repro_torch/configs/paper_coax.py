"""COAX index-side configuration defaults (the paper's own experiment setup,
§8.1): datasets, workload shapes, and index tuning used by the benchmarks."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CoaxExperimentConfig:
    airline_rows: int = 2_000_000       # paper: 80M (scaled for CPU CI; --rows overrides)
    osm_rows: int = 2_000_000           # paper: 105M
    airline_2008_rows: int = 700_000    # paper Fig. 7: 7M (year 2008 slice)
    n_queries: int = 200
    knn_k: int = 100                    # controls selectivity (paper §8.1.2)
    selectivities: tuple = (10, 100, 1_000, 10_000)  # K sweep for Fig. 7
    rtree_node_cap: int = 10            # paper: best between 8 and 12
    seed: int = 7


CONFIG = CoaxExperimentConfig()
