"""Carry the reference's LM parameters into the port.

The reference (``repro.models.model.Model.init``) keeps each layer stack
as one tree whose leaves have a leading layer axis; the port keeps an
``nn.ModuleList`` of layers whose parameters have the reference's leaf
names. ``from_reference`` takes the reference's parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns a port ``Model`` holding exactly those values:

* the stacks ``layers``, ``dense_layers`` and ``encoder`` are split
  along their layer axis into ``layers.0``, ``layers.1``, ...;
* gemma3's ``groups`` are split by group, and each group's ``local``
  stack by layer (``groups.0.local.1.attn.wq``);
* zamba2's ``shared_attn`` is the one shared block, as it is there.

``flatten`` maps ANY tree shaped like the reference's parameters —
gradients, Adam moments — to ``{port_name: np.ndarray}``, so the tests
compare them by name; ``to_reference`` is its inverse, from port names
back to the reference's nested, stacked tree (the layout of a
checkpoint either package can restore).

Nothing here imports jax: the caller converts the arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

# subtrees whose leaves carry a leading layer (or group) axis
STACKED = frozenset({"layers", "dense_layers", "encoder", "groups",
                     "local"})


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _take(tree: dict, i: int) -> dict:
    return {k: _take(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def flatten(tree: dict, prefix: str = "") -> dict:
    """A tree shaped like the reference's parameters (the parameters, or
    their gradients or Adam moments) as ``state_dict`` names of the
    port's ``Model`` -> numpy arrays, stacked axes split."""
    out = {}
    for key, val in tree.items():
        name = prefix + key
        if not isinstance(val, dict):
            out[name] = np.asarray(val)
        elif key in STACKED:
            n = len(next(_leaves(val)))
            for i in range(n):
                out.update(flatten(_take(val, i), f"{name}.{i}."))
        else:
            out.update(flatten(val, name + "."))
    return out


def from_reference(cfg: ModelConfig, params: dict, *,
                   device="cuda") -> Model:
    """A ``Model(cfg, device=device)`` holding the reference's parameters
    (nested dicts of float32 numpy arrays). Every parameter of the port
    must be given, with its shape, and nothing else."""
    model = Model(cfg, device=device)
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flatten(params).items()}
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{cfg.name}: parameters missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    bad = [(k, tuple(state[k].shape), tuple(p.shape))
           for k, p in own.items() if state[k].shape != p.shape]
    if bad:
        raise ValueError(f"{cfg.name}: shapes differ (name, given, "
                         f"port): {bad[:5]}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(state[k])
    return model


def _stack(children: list):
    """Trees of equal structure -> one tree, leaves stacked on a new
    leading axis."""
    first = children[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in children]) for k in first}
    return np.stack(children)


def _nest(items: dict) -> dict:
    """``{dotted name: array}`` -> nested dicts, the children of the
    stacked subtrees (whose keys are layer indices) stacked in index
    order."""
    tree: dict = {}
    for name, val in items.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val

    def fold(key, node):
        if not isinstance(node, dict):
            return node
        node = {k: fold(k, v) for k, v in node.items()}
        if key in STACKED and all(k.isdigit() for k in node):
            return _stack([node[str(i)] for i in range(len(node))])
        return node
    return {k: fold(k, v) for k, v in tree.items()}


def to_reference(named: dict) -> dict:
    """The inverse of ``flatten``: ``{port_name: tensor or array}`` (a
    model's ``named_parameters()``, their gradients, Adam moments) ->
    the reference's nested tree of float32 numpy arrays, each stack's
    layers on a leading axis."""
    arrays = {k: (v.detach().to("cpu", torch.float32).numpy()
                  if isinstance(v, torch.Tensor)
                  else np.asarray(v, dtype=np.float32))
              for k, v in named.items()}
    return _nest(arrays)
