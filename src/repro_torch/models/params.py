"""Load a reference parameter tree into the port's model.

The reference keeps parameters as a pytree whose layer leaves are stacked
``[num_groups, ...]`` under ``groups/layer_0/...`` (group period 1 for the
dense family).  :func:`params_from_jax` takes that tree as nested dicts of
numpy arrays and copies each leaf into the parameter of the same path, so
both packages compute with the same numbers.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..core.executor import resolve_device
from .model import Model

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
            raise KeyError(f"no parameter at {'/'.join(path)}")
    return obj


def _copy(dst: torch.nn.Parameter, src, path) -> None:
    # float32 first: numpy has no bf16 of its own
    t = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.data.copy_(t)


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device="cuda") -> Model:
    """A float32 :class:`Model` holding ``tree``'s numbers (every parameter
    must be present, and nothing else)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev, dtype=torch.float32)
    done = set()
    for path, arr in _leaves(tree):
        if path[0] == "groups":
            if path[1] != "layer_0":
                raise KeyError(f"{'/'.join(path)}: the dense family has one "
                               f"layer a group")
            arr = np.asarray(arr, dtype=np.float32)
            if arr.shape[0] != len(model.layers):
                raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} groups, "
                                 f"{len(model.layers)} layers")
            for i, layer in enumerate(model.layers):
                _copy(_param(layer, path[2:]), arr[i], path)
                done.add(("layers", str(i)) + path[2:])
        else:
            _copy(_param(model, path), arr, path)
            done.add(path)
    want = {tuple(n.split(".")) for n, _ in model.named_parameters()}
    if want != done:
        raise KeyError(f"parameters not in the tree: "
                       f"{sorted('.'.join(p) for p in want - done)}")
    return model
