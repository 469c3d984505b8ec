"""Production / host mesh construction on PyTorch devices.

A :class:`Mesh` is the port's counterpart of a jax mesh for the graph
engine's single-controller mesh path (DESIGN.md §10): an array of
``torch.device`` slots of the given shape and its axis names.  One process
drives every slot; slots that name the same physical device share it.

Model meshes are PyTorch's own: :func:`make_model_mesh` and
:func:`make_production_model_mesh` build a ``torch.distributed``
:class:`DeviceMesh` with named dims over the ranks of the current process
group (one rank per card: NCCL on cards, gloo on the CPU, or a fake group
for the dry run).  They sit beside the graph engine's single-controller
:class:`Mesh`, whose constructors keep their signatures.

Every constructor derives its device requirement from the requested shape
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
           "make_production_mesh", "make_model_mesh", "make_production_model_mesh",
           "PRODUCTION_SHAPES"]

#: the production model meshes: one pod (16 x 16) and two (2 x 16 x 16)
PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


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
        "pass device='cpu' for a host mesh of any size, or start a model "
        f"mesh's {need} ranks (torchrun)"
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


def make_model_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device_type: str = "cuda"):
    """A :class:`DeviceMesh` of ``shape`` with dims named ``axes`` over the
    first ``prod(shape)`` ranks of the current process group, in rank
    order (row-major).  Too few ranks raises :func:`mesh_device_error`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         "in rank")
    have = dist.get_world_size() if dist.is_initialized() else 0
    need = int(np.prod(shape))
    if have < need:
        raise mesh_device_error(shape, have)
    ranks = torch.arange(need, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_model_mesh(*, multi_pod: bool = False,
                               device_type: str = "cuda"):
    """16x16 ``("data", "model")`` (one pod, 256 cards) or 2x16x16
    ``("pod", "data", "model")`` (512) over the current process group."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_model_mesh(shape, axes, device_type=device_type)
