"""Carry parameters and optimizer state between the JAX package's layout
and the port's ``Model``, both ways.

The reference's parameter tree (nested dicts; ``jax.tree.map(np.asarray,
params)`` on its side) stacks the layers on a leading ``L`` axis; the
port holds one ``DecoderLayer`` per layer, named ``layers.<i>.<path>``.
The ``(in, out)`` layout is kept as it is: the math is ``x @ W`` in both.

- ``load_reference_params`` / ``load_reference_opt`` copy a reference tree
  into the port's model / AdamW state (in place, slicing each stacked
  leaf);
- ``reference_tree`` views the port's parameters, or any mapping keyed
  like them (AdamW's ``mu`` and ``nu``), in the reference's layout,
  without copying: each stacked leaf is a ``Stacked`` tuple of the
  per-layer tensors.  The checkpointer writes such a tree as the
  reference's npz (``np.stack`` of the layers) and restores it in place.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .model import Model
from .transformer import load_tree

__all__ = ["Stacked", "reference_tree", "load_reference_params",
           "load_reference_opt"]


class Stacked(tuple):
    """One leaf of the reference's tree, ``(L, ...)``, as the port's ``L``
    per-layer tensors (the live tensors, in layer order)."""


def _put(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def reference_tree(named) -> Dict[str, Any]:
    """The reference's nested layout of a module's named parameters, or of
    a mapping keyed like them: ``layers.<i>.<path>`` becomes the
    ``Stacked`` leaf ``["layers"][<path>]``, every other ``a.b`` becomes
    ``["a"]["b"]``.  No tensor is copied."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            stacks.setdefault(tuple(parts[2:]), {})[int(parts[1])] = t
        else:
            _put(tree, parts, t)
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"layers.*.{'.'.join(path)}: layers "
                             f"{sorted(by_layer)} are not 0..L-1")
        _put(tree, ("layers",) + path,
             Stacked(by_layer[i] for i in range(len(by_layer))))
    return tree


def _port_names(tree: Mapping[str, Any], n_layers: int) -> Dict[str, Any]:
    """A reference tree -> ``{port parameter name: array}``, each stacked
    leaf sliced into its ``n_layers`` layers."""
    flat: Dict[str, Any] = {}
    stack = [("", tree, False)]
    while stack:
        prefix, node, layered = stack.pop()
        for k, v in node.items():
            if isinstance(v, Mapping):
                stack.append((f"{prefix}{k}.", v, layered or k == "layers"))
                continue
            if not layered:
                flat[f"{prefix}{k}"] = v
                continue
            v = np.asarray(v)
            if v.shape[0] != n_layers:
                raise ValueError(f"{k}: {v.shape[0]} stacked layers, the "
                                 f"model has {n_layers}")
            rest = f"{prefix}{k}".split(".", 1)[1]      # after "layers."
            for i in range(n_layers):
                flat[f"layers.{i}.{rest}"] = v[i]
    return flat


def load_reference_params(model: Model, params: Mapping[str, Any]) -> Model:
    """Copy the reference tree ``params`` into ``model`` (cast to each
    parameter's dtype, moved to its device); every parameter must be
    given, with its shape, and nothing else.  Returns the model."""
    load_tree(model, _port_names(params, model.cfg.n_layers))
    return model


@torch.no_grad()
def load_reference_opt(state: Dict, opt: Mapping[str, Any]) -> Dict:
    """Copy the reference's AdamW state ``{"mu", "nu", "step"}`` into the
    port's ``state`` (``adamw_init``'s layout) in place; ``mu`` and ``nu``
    must name exactly the state's parameters, with their shapes.  Returns
    ``state``."""
    n_layers = len({name.split(".")[1] for name in state["mu"]
                    if name.startswith("layers.")})
    flat = {key: _port_names(opt[key], n_layers) for key in ("mu", "nu")}
    for key, given in flat.items():               # check all, then copy
        own = state[key]
        if set(given) != set(own):
            raise KeyError(f"{key}: names differ: missing "
                           f"{sorted(set(own) - set(given))}, unknown "
                           f"{sorted(set(given) - set(own))}")
        for name, val in given.items():
            if tuple(np.shape(val)) != tuple(own[name].shape):
                raise ValueError(f"{key}.{name}: shape {np.shape(val)}, "
                                 f"the state holds {tuple(own[name].shape)}")
    for key, given in flat.items():
        for name, val in given.items():
            state[key][name].copy_(torch.as_tensor(np.array(val, np.float32)))
    state["step"] = int(np.asarray(opt["step"]))
    return state
