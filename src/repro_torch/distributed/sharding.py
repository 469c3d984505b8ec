"""Logical-axis sharding: rules mapping model-space axes to mesh axes.

The port of ``repro/distributed/sharding.py``.  Models name the axes of
their parameters and activations with *logical* names (``models/common.py``
and every ``*_specs`` function); a rule set maps them onto the axes of a
model mesh, a ``torch.distributed`` :class:`DeviceMesh` with named dims.
The same model code runs unsharded (no mesh: ``ac`` is the identity, the
one-card path), on one pod's ``("data", "model")`` mesh or on the
``("pod", "data", "model")`` mesh by swapping rules.  A checkpoint stores
logical axes, not mesh axes, so it restores onto any mesh shape
(``fault_tolerance.elastic_reshard``).

Under a mesh, parameters, batches and caches are DTensors whose
placements the rules name (model code reads every parameter through
:func:`fsdp_gather`, FSDP's gather over the batch axes): a tensor dim
mapped to a mesh dim is ``Shard(dim)`` there, every other mesh dim
``Replicate()``, and a dim mapped to ``("pod", "data")`` is sharded over
both, pod-major, as the reference's ``PartitionSpec(("pod", "data"))`` is.
``ac`` redistributes an activation, the reference's
``with_sharding_constraint``.

DTensor has no sharding rule for a few of the model's ops on some
placements, where GSPMD pads or reshards by itself; the model places them
at their call sites.  A dim split into heads that the mesh does not
divide (two KV heads on a 16-wide ``model`` axis) is gathered first
(:func:`whole_heads`); attention, the SSM recurrences and the MoE's
routing, which has ``searchsorted``, run on each rank's own batch rows
(:func:`on_local_shards`).  :class:`MeshOps`, which
:meth:`ShardingCtx.scope` enters, lets every other op run as DTensor runs
it and raises where DTensor fails, but for one repair it counts
(``MeshOps.fallbacks``, reported per cell by the dry run).

The graph engine's mesh path (``VSWEngine(mesh=...)``) drives its devices
from one process with the single-controller ``launch.mesh.Mesh`` and needs
no partition specs, so there is no ``graph_ctx``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["MeshAxes", "DEFAULT_RULES", "SINGLE_POD_RULES", "with_seq_sharding",
           "ShardingCtx", "LOCAL_CTX", "MeshOps", "distribute_module",
           "full_tensor", "is_dtensor", "distribute_host", "whole_heads", "fsdp_gather", "on_local_shards", "BATCH_AXES"]

MeshAxes = Union[str, Tuple[str, ...], None]

#: default rules for the production (pod, data, model) mesh
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": ("pod", "data"),  # FSDP: shard params' d_model dim
    "qkv": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "inner": "model",
    "layers": None,
    "kvseq": None,
    "heads": "model",  # per-head state/cache dims (SSM states, KV heads)
    "heads_kv": "model",
    "kvshard": None,  # attention scores' key dim (seq-parallel opt-in)
    "embed_expert": ("pod", "data"),  # expert weights' d_model dim (FSDP)
    "mlp_expert": None,  # expert weights' d_ff dim
}

#: single-pod rules (no "pod" axis in the mesh)
SINGLE_POD_RULES: Dict[str, MeshAxes] = {
    **DEFAULT_RULES,
    "batch": "data",
    "embed": "data",
    "embed_expert": "data",
}


#: sequence-sharded variant for long-context cells (activation seq dim over
#: the model axis; params as in the base rules)
def with_seq_sharding(rules: Dict[str, MeshAxes]) -> Dict[str, MeshAxes]:
    return {**rules, "kvseq": "model"}


def _axes(ax: MeshAxes) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass
class ShardingCtx:
    """Runtime context threaded through model code: the mesh (``None``: one
    device), the logical-axis rules, and the attention settings."""

    #: a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
    mesh: Optional[object] = None
    rules: Optional[Dict[str, MeshAxes]] = None
    #: ``"torch"``: the plain path (the reference's ``"xla"``); ``"cuda"``:
    #: the hand-written kernel (the reference's ``"pallas"``)
    attn_impl: str = "cuda"
    #: kv-block size for the memory-bounded blocked attention path (0 =
    #: full materialization); used by the ``"torch"`` path only
    attn_block_k: int = 0
    #: store attention probabilities in bf16 (f32 softmax stats kept);
    #: the ``"torch"`` path only, as in the reference
    attn_bf16_probs: bool = False

    def __post_init__(self):
        if self.mesh is not None and not self.mesh.mesh_dim_names:
            raise ValueError("the mesh's dims need names")

    def spec(self, *logical: Optional[str]) -> Tuple[MeshAxes, ...]:
        """The mesh axes of each tensor dim (the reference's
        ``PartitionSpec`` as a tuple; ``()`` without rules)."""
        if self.rules is None:
            return ()
        return tuple(self.rules.get(ax) if ax else None for ax in logical)

    def placements_of(self, mesh_axes: Sequence[MeshAxes]) -> List:
        """DTensor placements for a tensor whose dim ``i`` is sharded over
        ``mesh_axes[i]`` (a name, a tuple of names, or ``None``)."""
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, ax in enumerate(mesh_axes):
            for a in _axes(ax):
                if a not in names:
                    raise ValueError(f"mesh axis {a!r} is not in the mesh "
                                     f"{tuple(names)}")
                k = names.index(a)
                if out[k] != Replicate():
                    raise ValueError(f"mesh axis {a!r} shards two dims of "
                                     f"{tuple(mesh_axes)}")
                out[k] = Shard(dim)
        return out

    def placements(self, *logical: Optional[str]) -> List:
        """DTensor placements of a tensor with these logical axes."""
        return self.placements_of(self.spec(*logical))

    def ac(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        """Activation sharding constraint: a redistribute of a DTensor (a
        plain tensor, the same on every rank, is split locally); the
        identity without a mesh."""
        if self.mesh is None or self.rules is None:
            return x
        want = self.placements(*logical)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        if list(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def param_sharding(self, specs: Dict[str, tuple]) -> Dict[str, List]:
        """Parameter name -> placements, from ``{name: logical axes}``."""
        assert self.mesh is not None and self.rules is not None
        return {n: self.placements(*spec) for n, spec in specs.items()}

    @contextlib.contextmanager
    def scope(self, mode: Optional["MeshOps"] = None):
        """The context model code runs in under a mesh: plain tensors (the
        same on every rank) mix with DTensors as replicated ones, under
        :class:`MeshOps` (or ``mode``, a subclass).  Nothing without a
        mesh."""
        if self.mesh is None:
            yield
            return
        from torch.distributed.tensor.experimental import implicit_replication
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        if any(isinstance(m, MeshOps) for m in _get_current_dispatch_mode_stack()):
            yield  # inside a caller's scope already
            return
        with implicit_replication(), (mode or MeshOps()):
            yield


def _is_dtensor_op(types) -> bool:
    for t in types:
        if t is DTensor or issubclass(t, DTensor):
            return True
    return False


class MeshOps(TorchDispatchMode):
    """The mode model code runs in under a mesh: DTensor ops run as
    DTensor runs them, and subclasses see every local op DTensor
    dispatches, collectives included, in :meth:`local_op` (the dry run
    counts them there).

    A DTensor op is called again with the mode on the stack, and the mode
    steps aside for that call (it returns ``NotImplemented``, which lets
    DTensor dispatch), so DTensor's local ops come back through it.  The
    model places the ops DTensor has no rule for at their call sites
    (``whole_heads``, ``on_local_shards``), so a failure raises, with one
    repair: a view that DTensor places but whose shard's strides make it
    fail (a transposed matmul gradient: DTensor tracks the global strides
    only) runs on contiguous copies of the shards, with no data moved
    between ranks.  :attr:`fallbacks` counts those repairs, ``(op,
    "contiguous shards")`` -> calls."""

    def __init__(self):
        super().__init__()
        self._step_aside = False
        self.fallbacks: collections.Counter = collections.Counter()

    def local_op(self, func, args, kwargs):
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_dtensor_op(types):
            return self.local_op(func, args, kwargs)
        if self._step_aside:
            self._step_aside = False
            return NotImplemented
        try:
            return self._as_dtensor(func, args, kwargs)
        except RuntimeError:
            if not (func.is_view and _strided_shards(args, kwargs)):
                raise
        self.fallbacks[(str(func), "contiguous shards")] += 1
        with self:  # the copies are local ops a subclass counts
            args, kwargs = tree_map(_contiguous_shard, (args, kwargs))
        return self._as_dtensor(func, args, kwargs)

    def _as_dtensor(self, func, args, kwargs):
        with self:
            self._step_aside = True
            try:
                return func(*args, **kwargs)
            finally:
                self._step_aside = False


def _strided_shards(args, kwargs) -> bool:
    return any(is_dtensor(x) and not x._local_tensor.is_contiguous()
               for x in tree_leaves((args, kwargs)))


def _contiguous_shard(x):
    """A DTensor with a contiguous copy of its shard, else ``x``."""
    if not is_dtensor(x) or x._local_tensor.is_contiguous():
        return x
    return DTensor(x._local_tensor.contiguous(), x._spec, requires_grad=False)


def on_local_shards(fn, args, dims, out_dims):
    """``fn(*args)`` on each rank's own batch rows and heads, for work that
    is independent across both (attention, the SSM recurrences).

    ``args[0]`` is a DTensor whose dim 0 is the batch and whose dim
    ``dims[0]`` the heads; every argument ``i`` (a DTensor or a plain
    tensor, the same on every rank) is brought to that batch and head split
    along its dims 0 and ``dims[i]``, every other dim whole, and ``fn``
    runs on the local tensors.  Output ``j`` comes back as a DTensor split
    along dims 0 and ``out_dims[j]``.  DTensor's own rules would regroup a
    split head dim, and plan a strided placement slowly or run every head
    everywhere.  ``dims=None``: batch rows only, every other dim whole in
    and out (the MoE's routing).  The splits must be even."""
    ref = args[0]
    mesh = ref.device_mesh
    if dims is None:
        dims, out_dims = (None,) * len(args), itertools.repeat(None)
    kinds = ["batch" if p == Shard(0) else
             "head" if dims[0] is not None and p == Shard(dims[0]) else None
             for p in ref.placements]

    def placements(head):
        return [Shard(0) if k == "batch" else Shard(head) if k == "head" else
                Replicate() for k in kinds]

    def local(x, head):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return x.redistribute(mesh, placements(head)).to_local()

    outs = fn(*(local(x, d) for x, d in zip(args, dims)))
    single = not isinstance(outs, tuple)
    wrapped = []
    for o, head in zip((outs,) if single else outs, out_dims):
        o = o.contiguous()
        shape = list(o.shape)
        for d, p in enumerate(placements(head)):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(d)
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        wrapped.append(DTensor.from_local(o, mesh, placements(head), run_check=False,
                                          shape=torch.Size(shape), stride=tuple(stride)))
    return wrapped[0] if single else tuple(wrapped)


def whole_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x [..., n * k]`` ready to be viewed as ``n`` heads of ``k``: a
    DTensor whose mesh split of the last dim does not divide the ``n``
    heads (two KV heads, or xLSTM's 4, on a 16-wide ``model`` axis) has
    those mesh dims gathered first, since DTensor splits a dim into heads
    only by whole heads; anything else as it is."""
    if not is_dtensor(x):
        return x
    last = Shard(x.dim() - 1)
    split = 1
    for d, p in enumerate(x.placements):
        if p == last:
            split *= x.device_mesh.size(d)
    if n % split == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p == last else p
                                          for p in x.placements])


def grad_as_placed(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient the backward first brings to ``x``'s
    placements.  A DTensor's gradient may come split where ``x`` is whole
    (the gradient of a linear layer's input is split along the weight's
    split dim), and a view of it into heads then fails where the mesh axis
    is wider than the heads (xLSTM's 4 heads on a 16-wide ``model`` axis).
    A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def loop_reckoner():
    """The dispatch mode on the stack that reckons a run's loops instead of
    running every trip (the dry run's ``CellCounter``, which counts one
    trip as many: its ``trips`` method), or ``None``: the model then runs
    every trip."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "reckons_loops", False):
            return mode
    return None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor of a model mesh)."""
    return isinstance(x, DTensor)



#: the mesh axes the batch is split over, and FSDP shards parameters over
BATCH_AXES = ("pod", "data")


def fsdp_gather(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the ops use it: a DTensor all-gathered over the
    mesh's batch axes (FSDP's gather before use; its backward
    reduce-scatters the gradient), its model-axis shards kept; a plain
    tensor as it is.  Without it DTensor would often move the activations
    to the parameter's shards instead (an FSDP-sharded norm scale turns
    the batch split into a split of d_model)."""
    if not is_dtensor(p):
        return p
    names = p.device_mesh.mesh_dim_names
    want = [Replicate() if names[d] in BATCH_AXES else pl
            for d, pl in enumerate(p.placements)]
    if want == list(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


def distribute_host(t: torch.Tensor, mesh, placements, device,
                    dtype=None) -> DTensor:
    """A DTensor of ``t``, a whole value every rank holds (on the host, as
    a restored checkpoint's leaf is), on ``mesh`` under ``placements``:
    each rank slices its own shard where ``t`` lies and moves only that
    to ``device`` (cast to ``dtype``).  No data moves between ranks."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous().to(device, dtype), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def full_tensor(x):
    """A DTensor's whole value on every rank (a collective); any other
    value as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def distribute_module(module: torch.nn.Module, ctx: "ShardingCtx",
                      placements: Dict[str, List], *,
                      requires_grad: Optional[bool] = None) -> torch.nn.Module:
    """Replace each parameter ``name`` of ``module`` by a DTensor on
    ``ctx.mesh`` under ``placements[name]``, split locally: every rank
    holds the same whole tensor (drawn from one seed, or restored), so no
    data moves.  In place; returns the module."""
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        dt = distribute_tensor(p.detach(), ctx.mesh, placements[name],
                               src_data_rank=None)
        flag = p.requires_grad if requires_grad is None else requires_grad
        setattr(mod, attr, torch.nn.Parameter(dt, requires_grad=flag))
    return module


LOCAL_CTX = ShardingCtx()  # one device, the kernel path
