"""Load a reference parameter tree into the port's model.

The reference keeps parameters as a pytree whose layer leaves are stacked
``[num_groups, ...]`` under ``groups/layer_j/...`` (``j`` below the group
period), and an encoder's under ``encoder/groups/layer_0/...``.
:func:`params_from_jax` takes that tree as nested dicts of numpy arrays
and copies each leaf into the parameter of the same path, group ``g`` of
``layer_j`` into ``layers[g * period + j]``, so both packages compute with
the same numbers.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..core.executor import resolve_device
from .model import Model, _encoder_cfg

__all__ = ["params_from_jax"]


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        elif v is not None:
            yield path + (k,), v


def _param(module, path) -> torch.nn.Parameter:
    obj = module
    for name in path:
        obj = getattr(obj, name, None)
        if obj is None:
            break
    if not isinstance(obj, torch.nn.Parameter):
        raise KeyError(f"no parameter at {'/'.join(path)}")
    return obj


def _copy(dst: torch.nn.Parameter, src, path) -> None:
    # float32 first: numpy has no bf16 of its own
    t = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.data.copy_(t)


def _copy_groups(layers, prefix, period: int, path, arr, done) -> None:
    """``groups/layer_j/<rest>`` leaves ``[G, ...]`` into ``layers[g *
    period + j]``."""
    name = path[1]
    idx = name.removeprefix("layer_")
    j = int(idx) if idx != name and idx.isdigit() else -1
    if not 0 <= j < period:
        raise KeyError(f"{'/'.join(path)}: no {name} in a group of {period}")
    arr = np.asarray(arr, dtype=np.float32)
    groups = len(layers) // period
    if arr.shape[0] != groups:
        raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} groups, {groups} in "
                         f"the model")
    for g in range(groups):
        i = g * period + j
        _copy(_param(layers[i], path[2:]), arr[g], path)
        done.add(prefix + ("layers", str(i)) + path[2:])


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device="cuda") -> Model:
    """A float32 :class:`Model` holding ``tree``'s numbers (every parameter
    must be present, and nothing else)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev, dtype=torch.float32)
    done = set()
    for path, arr in _leaves(tree):
        if path[0] == "groups":
            _copy_groups(model.layers, (), cfg.group_period, path, arr, done)
        elif path[:2] == ("encoder", "groups") and model.encoder is not None:
            _copy_groups(model.encoder.layers, ("encoder",),
                         _encoder_cfg(cfg).group_period, path[1:], arr, done)
        else:
            _copy(_param(model, path), arr, path)
            done.add(path)
    want = {tuple(n.split(".")) for n, _ in model.named_parameters()}
    if want != done:
        raise KeyError(f"parameters not in the tree: "
                       f"{sorted('.'.join(p) for p in want - done)}")
    return model
