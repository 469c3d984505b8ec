"""The reference's parameter layout: load it into the port, and build it.

The reference keeps parameters as a pytree whose layer leaves are stacked
``[num_groups, ...]`` under ``groups/layer_j/...`` (``j`` below the group
period), and an encoder's under ``encoder/groups/layer_0/...``.  The port
keeps one tensor per layer: layer ``g * period + j`` holds group ``g`` of
``layer_j`` (:func:`reference_path`).

- :func:`params_from_jax` takes such a tree as nested dicts of numpy
  arrays and returns a :class:`Model` holding the same numbers.
- :func:`load_reference_tree` copies a tree into named tensors (a model's
  ``named_parameters()``, or AdamW's moments named alike).
- :func:`reference_tree` stacks named tensors back into the tree: the
  layout the checkpointer writes, so a checkpoint restores in either
  package; :func:`reference_groups` names the tensors each leaf stacks
  (gradient compression takes one threshold or scale over them, as the
  reference does over the stacked leaf).

Under a model mesh the named tensors are DTensors: :func:`reference_tree`
stacks their whole values (a collective every rank takes part in; only
the ranks that keep the tree hold it), and loading slices each rank's
shard from the host leaf (``sharding.distribute_host``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..core.executor import resolve_device
from .model import Model, _encoder_cfg

__all__ = ["params_from_jax", "load_reference_tree", "reference_groups",
           "reference_path", "reference_specs", "reference_tree"]


def reference_path(name: str, cfg: ModelConfig) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference leaf of the port's tensor ``name``, and the group it
    is a slice of (``None``: an unstacked leaf)."""
    parts = name.split(".")
    prefix, period = (), cfg.group_period
    if parts[0] == "encoder" and parts[1] == "layers":
        prefix, period, parts = ("encoder",), _encoder_cfg(cfg).group_period, parts[1:]
    if parts[0] != "layers":
        return tuple(name.split(".")), None
    g, j = divmod(int(parts[1]), period)
    return prefix + ("groups", f"layer_{j}") + tuple(parts[2:]), g


def reference_groups(names: Iterable[str], cfg: ModelConfig) -> Dict[Tuple[str, ...],
                                                                     List[str]]:
    """Reference leaf -> the port's tensor names it stacks, in group order
    (one name for an unstacked leaf)."""
    out: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
    for name in names:
        path, g = reference_path(name, cfg)
        out.setdefault(path, []).append((g or 0, name))
    return {path: [n for _, n in sorted(gs)] for path, gs in out.items()}


@torch.no_grad()
def reference_tree(named: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   device=None, *, keep: bool = True) -> Optional[Dict]:
    """Nested dicts in the reference's layout: each stacked leaf is the
    ``torch.stack`` of its groups' tensors (a copy, on their device), an
    unstacked leaf the tensor itself.  With ``device`` every leaf is a new
    tensor there, each tensor copied once (``meta``: shapes and dtypes
    only).

    A DTensor's whole value is gathered one tensor at a time (a collective
    every rank of its mesh joins), so a rank's card holds one gathered
    tensor at once.  ``keep=False`` joins the same gathers, keeps nothing
    and returns ``None``: the ranks that do not write a checkpoint, so
    that one host holds the whole tree."""
    from ..distributed.sharding import full_tensor

    def whole(n):
        return full_tensor(named[n].detach())

    tree: Dict = {}
    for path, names in reference_groups(named, cfg).items():
        first = named[names[0]]
        if device is not None and torch.device(device).type == "meta":
            # shapes and dtypes only: no gather
            stacked = reference_path(names[0], cfg)[1] is not None
            shape = (len(names), *first.shape) if stacked else tuple(first.shape)
            leaf = torch.empty(shape, dtype=first.dtype, device="meta")
        elif not keep:
            for n in names:
                whole(n)
            continue
        elif reference_path(names[0], cfg)[1] is None:
            leaf = whole(names[0]) if device is None else whole(names[0]).to(
                device, copy=True)
        elif device is None:
            leaf = torch.stack([whole(n) for n in names])
        else:
            leaf = torch.empty((len(names), *first.shape), dtype=first.dtype,
                               device=device)
            for i, n in enumerate(names):
                leaf[i].copy_(whole(n))
        _put(tree, path, leaf)
    return tree if keep else None


def reference_specs(specs: Mapping[str, tuple], cfg: ModelConfig) -> Dict:
    """``{name: logical axes}`` (``models/model.py::param_specs``) in the
    reference's layout: a stacked leaf's spec with the group axis
    ``"layers"`` in front, as the reference's ``param_specs`` gives it."""
    tree: Dict = {}
    for name, spec in specs.items():
        path, g = reference_path(name, cfg)
        _put(tree, path, spec if g is None else ("layers",) + tuple(spec))
    return tree


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        elif v is not None:
            yield path + (k,), v


def _target(named: Mapping[str, torch.Tensor], path) -> torch.Tensor:
    t = named.get(".".join(path))
    if t is None:
        raise KeyError(f"no parameter at {'/'.join(path)}")
    return t


def _tensor(src) -> torch.Tensor:
    """A tensor as it is; an array through f32 (numpy has no bf16 of its
    own)."""
    if isinstance(src, torch.Tensor):
        return src
    return torch.tensor(np.asarray(src, dtype=np.float32))


@torch.no_grad()
def _copy(dst: torch.Tensor, src, path) -> None:
    src = _tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    from ..distributed.sharding import distribute_host, is_dtensor

    if is_dtensor(dst):
        local = dst.to_local()
        src = distribute_host(src, dst.device_mesh, dst.placements, local.device,
                              local.dtype)
    dst.copy_(src)


def _copy_groups(named, prefix, period: int, layers: int, path, arr, done) -> None:
    """``groups/layer_j/<rest>`` leaves ``[G, ...]`` into ``layers.<g *
    period + j>.<rest>``."""
    name = path[1]
    idx = name.removeprefix("layer_")
    j = int(idx) if idx != name and idx.isdigit() else -1
    if not 0 <= j < period:
        raise KeyError(f"{'/'.join(path)}: no {name} in a group of {period}")
    arr = _tensor(arr)
    groups = layers // period
    if arr.shape[0] != groups:
        raise ValueError(f"{'/'.join(path)}: {arr.shape[0]} groups, {groups} in "
                         f"the model")
    for g in range(groups):
        target = prefix + ("layers", str(g * period + j)) + path[2:]
        _copy(_target(named, target), arr[g], path)
        done.add(target)


def load_reference_tree(named: Mapping[str, torch.Tensor], tree: Dict,
                        cfg: ModelConfig) -> None:
    """Copy ``tree`` (the reference's layout; numpy arrays or tensors) into
    the tensors of ``named``, each cast to its tensor's dtype and device.
    Every tensor must be present in the tree, and nothing else."""
    done = set()
    for path, arr in _leaves(tree):
        if path[0] == "groups":
            _copy_groups(named, (), cfg.group_period, cfg.num_layers, path, arr, done)
        elif path[:2] == ("encoder", "groups") and cfg.encdec:
            enc = _encoder_cfg(cfg)
            _copy_groups(named, ("encoder",), enc.group_period, enc.num_layers,
                         path[1:], arr, done)
        else:
            _copy(_target(named, path), arr, path)
            done.add(path)
    want = {tuple(n.split(".")) for n in named}
    if want != done:
        raise KeyError(f"parameters not in the tree: "
                       f"{sorted('.'.join(p) for p in want - done)}")


def params_from_jax(tree: Dict, cfg: ModelConfig, *, device="cuda") -> Model:
    """A float32 :class:`Model` holding ``tree``'s numbers (every parameter
    must be present, and nothing else)."""
    model = Model(cfg, device=resolve_device(device), dtype=torch.float32)
    load_reference_tree(dict(model.named_parameters()), tree, cfg)
    return model
