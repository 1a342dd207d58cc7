"""Carry the JAX package's weights over into the port's ``Model``.

The reference's parameter tree, as numpy arrays (``jax.tree.map(np.asarray,
params)`` on its side), stacks the layers on a leading ``L`` axis; the
port holds one ``DecoderLayer`` per layer, so each leaf is sliced.  The
``(in, out)`` layout is kept as it is: the math is ``x @ W`` in both.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .model import Model
from .transformer import load_tree

__all__ = ["load_reference_params"]


def _layer(tree: Mapping[str, Any], i: int, n: int):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _layer(v, i, n)
            continue
        v = np.asarray(v)
        if v.shape[0] != n:
            raise ValueError(f"{k}: {v.shape[0]} stacked layers, the model "
                             f"has {n}")
        out[k] = v[i]
    return out


def load_reference_params(model: Model, params: Mapping[str, Any]) -> Model:
    """Copy the reference tree ``params`` into ``model`` (cast to each
    parameter's dtype, moved to its device); every parameter must be
    given, with its shape, and nothing else.  Returns the model."""
    tree = {k: v for k, v in params.items() if k != "layers"}
    n = model.cfg.n_layers
    tree["layers"] = {str(i): _layer(params["layers"], i, n)
                      for i in range(n)}
    load_tree(model, tree)
    return model
