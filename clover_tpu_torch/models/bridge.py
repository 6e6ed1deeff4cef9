"""Weight bridge: the JAX package's parameter tree -> the port's state.

Input is the tree ``clover_tpu`` models produce (``model.init(...)`` or
its ``["params"]``), as nested dicts of numpy arrays (``jax.device_get``).
The same rules carry a gradient tree and optax's AdamW moments
(``opt_state_from_jax``), so a run resumed from a JAX train state goes on
in the port. Leaf rules:

- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in), except the
  patch embed's ``proj``, which keeps its layout: the Dense (pd*ph*pw*C, E)
  or, with a stride other than the patch, the ``nn.Conv`` (pd, ph, pw, C,
  E);
- LayerNorm and BatchNorm ``scale`` -> ``weight``; ``Embed`` ``embedding``
  -> ``weight``;
- ``bias`` and ``relative_position_bias_table`` (table_len, nH) as they are;
- the ``batch_stats`` collection (BatchNorm's running ``mean`` / ``var``)
  -> the buffers of the same names.

Module paths map one to one (``a/b/c`` -> ``a.b.c``). A leaf that optax
masked out (``multi_transform``'s frozen leaves in the AdamW moments, an
empty ``MaskedNode``) carries nothing. This module needs numpy only; it
imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from clover_tpu_torch.models.layers import BatchNorm, LayerNorm

_RENAME = {"scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping,
            prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        elif not (isinstance(v, tuple) and len(v) == 0):   # optax's MaskedNode
            yield prefix + (str(k),), v


def state_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """{port state-dict name: fp32 array} for every leaf of ``params``."""
    if "params" in params:
        params = params["params"]
    state = {}
    for path, leaf in _leaves(params):
        *mods, name = path
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            if mods[-2:] != ["patch_embed", "proj"]:
                arr = arr.T
            name = "weight"
        key = ".".join(mods + [_RENAME.get(name, name)])
        if key in state:
            raise ValueError(f"two JAX leaves map to {key}")
        state[key] = np.ascontiguousarray(arr)
    return state


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping) -> None:
    """Copy the JAX tree into ``model``: ``params`` (or the tree's
    ``"params"``) into the parameters and, where the tree has one, its
    ``"batch_stats"`` into the BatchNorm buffers. Raises unless every leaf
    lands on exactly one tensor and every parameter (and, with batch_stats,
    every BatchNorm buffer) is set, with equal shapes."""
    collections = {"params": params.get("params", params)}
    own = {"params": dict(model.named_parameters())}
    if "batch_stats" in params:
        collections["batch_stats"] = params["batch_stats"]
        own["batch_stats"] = {n: b for n, b in model.named_buffers()
                              if isinstance(model.get_submodule(n.rpartition(".")[0]), BatchNorm)}
    for kind, tree in collections.items():
        state, mine = state_from_jax({"params": tree}), own[kind]
        missing, unexpected = sorted(mine.keys() - state.keys()), sorted(state.keys() - mine.keys())
        if missing or unexpected:
            raise KeyError(f"{kind}: tensors without a JAX leaf: {missing}; "
                           f"JAX leaves without a tensor: {unexpected}")
        for key, p in mine.items():
            arr = state[key]
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{key}: JAX shape {arr.shape}, port shape {tuple(p.shape)}")
            p.copy_(torch.tensor(arr))


def jax_leaf_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{port parameter name: its leaf path in the JAX tree}, the inverse of
    the leaf rules: a ``weight`` is ``kernel`` (Linear, the patch embed's
    ``proj``), ``scale`` (LayerNorm, BatchNorm) or ``embedding``
    (nn.Embedding)."""
    paths = {}
    for mod_name, mod in model.named_modules():
        leaf = ("scale" if isinstance(mod, (LayerNorm, BatchNorm)) else
                "embedding" if isinstance(mod, nn.Embedding) else "kernel")
        for name, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            paths[key] = tuple(mod_name.split(".") if mod_name else ()) + (
                leaf if name == "weight" else name,)
    return paths


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state (under
    ``multi_transform``, in its ``inner_states["train"]``)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    inner = getattr(opt_state, "inner_states", None)
    children = ([inner.get("train")] if isinstance(inner, Mapping) else
                opt_state if isinstance(opt_state, (tuple, list)) else
                [getattr(opt_state, "inner_state", None)])
    for child in children:
        if child is not None and not isinstance(child, (np.ndarray, np.generic)):
            found = _adam_state(child)
            if found is not None:
                return found
    return None


@torch.no_grad()
def opt_state_from_jax(opt_state, model: nn.Module, optimizer: torch.optim.Optimizer) -> int:
    """Carry optax's AdamW state (``make_optimizer``'s chain, as numpy via
    ``jax.device_get``) into ``optimizer``, a ``torch.optim.AdamW`` over
    ``model``'s parameters: ``mu`` / ``nu`` become ``exp_avg`` /
    ``exp_avg_sq`` through the leaf rules, ``count`` every parameter's
    ``step``. Under a freeze mask (``multi_transform``) the frozen leaves
    have no moments, and the parameters outside ``optimizer``'s groups
    get none. -> the count, which is the train state's step."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no AdamW moments (count, mu, nu) in the optax state")
    mu, nu = state_from_jax(adam.mu), state_from_jax(adam.nu)
    trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
    own = {n: p for n, p in model.named_parameters() if id(p) in trained}
    if own.keys() != mu.keys() or own.keys() != nu.keys():
        raise KeyError(f"moments do not match the parameters: "
                       f"{sorted(own.keys() ^ mu.keys())[:5]}")
    count = int(np.asarray(adam.count))
    for key, p in own.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(mu[key]).to(p.device, p.dtype),
            "exp_avg_sq": torch.tensor(nu[key]).to(p.device, p.dtype),
        }
    return count
