"""COAX core: the paper's contribution as a composable library (host side).

Public API
----------
COAXIndex / CoaxConfig       — the correlation-aware index (paper §3-§6)
learn_soft_fds / SoftFDConfig — soft-FD detection & model learning (§5, Alg. 1)
translate_rect               — query translation (Eq. 2)
GridFile                     — quantile grid file with sorted dim (§6)
FullScan / UniformGrid / ColumnFiles / STRTree — the §8.1.3 baselines
theory                       — §7 closed forms + simulations
"""
from .types import (
    FDGroup,
    FDPair,
    LinearModel,
    Rect,
    full_rect,
    point_rect,
    rect_contains,
    split_hits,
)
from .softfd import (
    BayesianLinearModel,
    SoftFDConfig,
    bayes_linear_regress,
    bucket_centres,
    detect_soft_fds,
    learn_soft_fds,
    merge_groups,
)
from .translate import (reduced_dims, translate_dependent_interval,
                        translate_rect, translate_rects)
from .gridfile import (BatchStats, GridFile, batched_searchsorted,
                       fit_cells_per_dim, gather_ranges)
from .delta import DeltaPlane
from .coax import COAXIndex, CoaxConfig
from .baselines import ColumnFiles, FullScan, STRTree, UniformGrid
from . import theory

__all__ = [
    "COAXIndex",
    "CoaxConfig",
    "FullScan",
    "UniformGrid",
    "ColumnFiles",
    "STRTree",
    "SoftFDConfig",
    "BayesianLinearModel",
    "LinearModel",
    "FDPair",
    "FDGroup",
    "Rect",
    "full_rect",
    "point_rect",
    "rect_contains",
    "split_hits",
    "bucket_centres",
    "bayes_linear_regress",
    "detect_soft_fds",
    "merge_groups",
    "learn_soft_fds",
    "translate_rect",
    "translate_rects",
    "translate_dependent_interval",
    "reduced_dims",
    "GridFile",
    "DeltaPlane",
    "BatchStats",
    "gather_ranges",
    "batched_searchsorted",
    "fit_cells_per_dim",
    "theory",
]
