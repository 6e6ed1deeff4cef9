"""Weight bridge: the JAX package's parameter tree -> the port's state.

Input is the tree ``clover_tpu`` models produce (``model.init(...)`` or
its ``["params"]``), as nested dicts of numpy arrays (``jax.device_get``).
Leaf rules:

- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in), except the
  patch embed's ``proj``, which keeps its (pd*ph*pw*C, E) layout;
- LayerNorm ``scale`` -> ``weight``; ``Embed`` ``embedding`` -> ``weight``;
- ``bias`` and ``relative_position_bias_table`` (table_len, nH) as they are.

Module paths map one to one (``a/b/c`` -> ``a.b.c``). This module needs
numpy only; it imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping,
            prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
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
    """Copy the JAX tree into ``model``. Raises unless every leaf lands on
    exactly one parameter and every parameter is set, with equal shapes."""
    state = state_from_jax(params)
    own = dict(model.named_parameters())
    missing, unexpected = sorted(own.keys() - state.keys()), sorted(state.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"parameters without a JAX leaf: {missing}; "
                       f"JAX leaves without a parameter: {unexpected}")
    for key, p in own.items():
        arr = state[key]
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{key}: JAX shape {arr.shape}, port shape {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
