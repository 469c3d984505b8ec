"""Production / host mesh construction on PyTorch devices.

A :class:`Mesh` is the port's counterpart of a jax mesh for the graph
engine's single-controller mesh path (DESIGN.md §10): an array of
``torch.device`` slots of the given shape and its axis names.  One process
drives every slot; slots that name the same physical device share it.

Both constructors derive their device requirement from the requested shape
and raise the same :class:`RuntimeError` (:func:`mesh_device_error`) when
there are too few devices, so callers (tests, the engine's ``mesh=`` boot
path) match on one message format.  On ``device="cpu"`` any count is
allowed: every slot is the CPU, the counterpart of XLA's forced host
device count.  On ``"cuda"`` the mesh takes the first ``prod(shape)``
cards.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["Mesh", "mesh_device_error", "make_host_mesh",
           "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device`` of the mesh's
    shape; ``axis_names``: one name per axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self):
        """The slots' devices in flattened (row-major) order."""
        return list(self.devices.flat)


def mesh_device_error(shape, have: int) -> RuntimeError:
    """The uniform too-few-devices error: count derived from ``shape``."""
    need = int(np.prod(shape))
    return RuntimeError(
        f"mesh shape {tuple(shape)} needs {need} devices, have {have} — "
        "pass device='cpu' for a host mesh of any size"
    )


def _take_devices(shape, device) -> np.ndarray:
    """The first ``prod(shape)`` devices of ``device``'s type as an array
    of ``shape``, or raise the uniform error.

    Taking a prefix when MORE cards exist is deliberate (a 2-slot mesh on
    a 4-card host); having FEWER is an error here rather than a confusing
    failure at the first launch.
    """
    kind = torch.device(device).type
    need = int(np.prod(shape))
    if kind == "cpu":
        devs = [torch.device("cpu")] * need
    elif kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise mesh_device_error(shape, have)
        devs = [torch.device("cuda", i) for i in range(need)]
    else:
        raise ValueError(f"unsupported mesh device {device!r}")
    out = np.empty(need, dtype=object)
    out[:] = devs
    return out.reshape(tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 (one pod, 256 devices) or 2x16x16 (two pods, 512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_take_devices(shape, device), axes)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *,
                   device="cuda") -> Mesh:
    """Tiny mesh (tests, examples, the engine's ``mesh=int`` boot path).
    Raises the uniform error instead of silently truncating to however
    many devices exist."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         "in rank")
    return Mesh(_take_devices(shape, device), tuple(axes))
