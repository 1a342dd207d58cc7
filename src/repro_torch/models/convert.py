"""Carry parameters and optimizer state between the JAX package's layout
and the port's ``Model``, both ways.

The reference's parameter tree (nested dicts; ``jax.tree.map(np.asarray,
params)`` on its side) stacks the layers on a leading ``L`` axis; the
port holds one module per layer, named ``layers.<i>.<path>``.  The
hybrid's shared blocks are a second stack, ``shared``, of its own length
(``shared.<j>.<path>`` in the port); the enc-dec's two stacks are
``enc_layers`` and ``dec_layers``.  An MoE layer's ``moe`` leaves keep
their expert axis after the layer axis: ``(L, E, D, F)`` in the
reference, ``(E, D, F)`` a layer in the port.
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

__all__ = ["Stacked", "STACKS", "reference_tree", "load_reference_params",
           "load_reference_opt"]

# the top-level entries of the reference's tree that stack layers
STACKS = ("layers", "shared", "enc_layers", "dec_layers")


class Stacked(tuple):
    """One leaf of the reference's tree, ``(L, ...)``, as the port's ``L``
    per-layer tensors (the live tensors, in layer order)."""


def _put(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def reference_tree(named) -> Dict[str, Any]:
    """The reference's nested layout of a module's named parameters, or of
    a mapping keyed like them: ``<stack>.<i>.<path>`` (a stack of
    ``STACKS``) becomes the ``Stacked`` leaf ``[<stack>][<path>]``, every
    other ``a.b`` becomes ``["a"]["b"]``.  No tensor is copied."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            key = (parts[0],) + tuple(parts[2:])
            stacks.setdefault(key, {})[int(parts[1])] = t
        else:
            _put(tree, parts, t)
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{path[0]}.*.{'.'.join(path[1:])}: layers "
                             f"{sorted(by_layer)} are not 0..L-1")
        _put(tree, path, Stacked(by_layer[i] for i in range(len(by_layer))))
    return tree


def _stack_lengths(names) -> Dict[str, int]:
    """{stack: its layer count} from port parameter names."""
    seen: Dict[str, set] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] in STACKS:
            seen.setdefault(parts[0], set()).add(parts[1])
    return {k: len(v) for k, v in seen.items()}


def _port_names(tree: Mapping[str, Any],
                lengths: Mapping[str, int]) -> Dict[str, Any]:
    """A reference tree -> ``{port parameter name: array}``, each leaf of
    a stack sliced into the ``lengths[stack]`` layers the model has."""
    flat: Dict[str, Any] = {}
    todo = [("", tree, None)]
    while todo:
        prefix, node, stack = todo.pop()
        for k, v in node.items():
            if isinstance(v, Mapping):
                top = k if prefix == "" and k in STACKS else None
                todo.append((f"{prefix}{k}.", v, stack or top))
                continue
            if stack is None:
                flat[f"{prefix}{k}"] = v
                continue
            v = np.asarray(v)
            n = lengths.get(stack, 0)
            if v.shape[0] != n:
                raise ValueError(f"{k}: {v.shape[0]} stacked layers in "
                                 f"'{stack}', the model has {n}")
            rest = f"{prefix}{k}".split(".", 1)[1]      # after "<stack>."
            for i in range(n):
                flat[f"{stack}.{i}.{rest}"] = v[i]
    return flat


def load_reference_params(model: Model, params: Mapping[str, Any]) -> Model:
    """Copy the reference tree ``params`` into ``model`` (cast to each
    parameter's dtype, moved to its device); every parameter must be
    given, with its shape, and nothing else.  Returns the model."""
    lengths = _stack_lengths(name for name, _ in model.named_parameters())
    load_tree(model, _port_names(params, lengths))
    return model


@torch.no_grad()
def load_reference_opt(state: Dict, opt: Mapping[str, Any]) -> Dict:
    """Copy the reference's AdamW state ``{"mu", "nu", "step"}`` into the
    port's ``state`` (``adamw_init``'s layout) in place; ``mu`` and ``nu``
    must name exactly the state's parameters, with their shapes.  Returns
    ``state``."""
    lengths = _stack_lengths(state["mu"])
    flat = {key: _port_names(opt[key], lengths) for key in ("mu", "nu")}
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
