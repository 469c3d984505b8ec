"""Multi-card dry run: reckon every (arch x shape x mesh) cell on fake tensors.

The port of ``repro/launch/dryrun.py``.  For each cell this shows, with no
card and no memory behind the tensors:

- the sharding is coherent: the step runs on DTensors of the mesh's
  placements (``distributed/sharding.py``), on a fake process group of the
  mesh's size (``torch.testing._internal.distributed.fake_pg``, backend
  ``"fake"``), every tensor a ``FakeTensor``;
- whether it fits a card's HBM: the peak of one rank's live local bytes;
- the roofline inputs of one rank: FLOPs, bytes and collective bytes.

Every shard of a parameter, batch or cache has the same shape (a dim its
mesh axes do not divide is replicated, as the reference's
``build_shardings`` does), so rank 0 stands for every card.  What is
counted, per local op that rank 0 dispatches (:class:`CellCounter`):

- **FLOPs**: ``torch.utils.flop_counter``'s formulas on the op's *local*
  shapes (matmul-class ops; elementwise ops count none).  A
  ``FlopCounterMode`` above DTensor would count the global op: 2·32·64·128
  for a ``[32, 64] @ [64, 128]`` on 256 fake ranks.
- **Bytes**: each op's local inputs read and outputs written (views
  move nothing).  Eager PyTorch fuses nothing, so this bounds the traffic
  from above; XLA's count in the reference is after fusion.
- **Collective bytes**: ``roofline.analysis.CollectiveCounter``.
- **Peak memory**: the arguments' local bytes (parameters, optimiser
  moments, batch, caches) plus the largest sum of live local storages the
  step allocates.  XLA's CPU upcast of bf16 temporaries, which the
  reference halves in ``peak_tpu_est``, does not happen here: ``peak_est``
  is the peak as counted, and ``fits_hbm`` holds it against
  ``hw.HBM_BYTES``.  No device memory is read.

The tensors hold no data: they are ``meta`` tensors (a shape, a dtype
and a storage size; each op runs its meta kernel), which count the bytes
a card's tensors would.  ``FakeTensorMode`` would do as well but runs the
step about half as fast, and makes DTensor's strided-shard bookkeeping
(index tensors DTensor builds and reads) raise where a real run does
not.  The mesh is typed ``cuda`` where a card
is visible, else ``cpu``; a fake group needs no card either way.
``attn_impl="torch"`` stands where the reference has ``"xla"``: the
plain attention, the blocked one for long prefill.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
      --out reports/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch graphmp   # the paper
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch

from .. import configs
from ..config import ModelConfig, SHAPES, ShapeConfig
from ..distributed.sharding import (
    DEFAULT_RULES, SINGLE_POD_RULES, ShardingCtx,
)
from ..models import model as M
from ..models import transformer as T
from ..optim import adamw
from ..roofline import analysis as RA
from ..roofline import hw
from ..train.step import make_train_step
from .mesh import PRODUCTION_SHAPES, make_model_mesh

__all__ = ["pick_rules", "build_shardings", "input_specs", "batch_specs_logical",
           "CellResult", "CellCounter", "fallback_counts", "OpBudgetExceeded", "FAKE_WORLD", "fake_mesh",
           "place_params", "lower_cell", "lower_graphmp",
           "run", "main", "default_mesh_type", "PREFILL_BLOCK_K", "HBM_BUDGET"]


def default_mesh_type() -> str:
    """The fake mesh's device type: ``cuda`` where a card is visible."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a :class:`DeviceMesh` (or any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# ----------------------------------------------------------------- sharding
def pick_rules(mesh, shape: ShapeConfig) -> Dict:
    sizes = _sizes(mesh)
    rules = dict(DEFAULT_RULES if "pod" in sizes else SINGLE_POD_RULES)
    # batch axes: greedy subset of (pod, data) that divides global_batch
    chosen = []
    rem = shape.global_batch
    for a in ("pod", "data"):
        if a in sizes:
            sz = sizes[a]
            if rem % sz == 0 and rem >= sz:
                chosen.append(a)
                rem //= sz
    rules["batch"] = tuple(chosen) if chosen else None
    if shape.mode == "decode":
        # Flash-decoding-style KV layout: shard the cache SEQUENCE over the
        # model axis (always divisible; kv-head counts often are not) —
        # attention reduces over the sharded axis via partial softmax.
        rules["kvseq"] = "model"
        rules["heads_kv"] = None
    if shape.name == "long_500k":
        # B=1: no data parallelism — spread the 512k cache over data too
        rules["kvseq"] = ("data", "model")
    return rules


def build_shardings(ctx: ShardingCtx, specs: Dict, shapes: Dict) -> Dict:
    """Logical specs -> placements, dropping mesh axes that don't divide
    their dim (that dim is replicated, e.g. whisper's vocab).  ``specs``
    and ``shapes`` are dicts of the same keys (nested alike): logical
    tuples, and tensors or shapes."""
    sizes = _sizes(ctx.mesh)

    def axis_size(ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            n = 1
            for a in ax:
                n *= sizes[a]
            return n
        return sizes[ax]

    def one(spec, shp):
        dims = tuple(shp.shape if isinstance(shp, torch.Tensor) else shp)
        mesh_axes = []
        for i, logical in enumerate(spec):
            ax = ctx.rules.get(logical) if logical else None
            if ax is not None and dims[i] % axis_size(ax) != 0:
                ax = None  # non-divisible: replicate this dim
            mesh_axes.append(ax)
        return ctx.placements_of(mesh_axes)

    def walk(sp, sh):
        if isinstance(sp, dict):
            return {k: walk(sp[k], sh[k]) for k in sp if sh.get(k) is not None}
        return one(sp, sh)

    return walk(specs, shapes)


# -------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins (``meta`` tensors) for every model input."""
    S = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    B = shape.global_batch
    if shape.mode == "train":
        batch = {
            "tokens": S((B, shape.seq_len), torch.int32),
            "labels": S((B, shape.seq_len), torch.int32),
        }
    elif shape.mode == "prefill":
        batch = {"tokens": S((B, shape.seq_len), torch.int32)}
    else:  # decode: one new token against a seq_len cache
        batch = {"tokens": S((B, 1), torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = S((B, cfg.prefix_len, cfg.d_model), torch.float32)
    if cfg.frontend == "audio_stub":
        batch["frames"] = S((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    return batch


def batch_specs_logical(cfg: ModelConfig, batch) -> Dict:
    out = {}
    for k, v in batch.items():
        if k in ("tokens", "labels"):
            out[k] = ("batch", None)
        else:
            out[k] = ("batch", None, None)
    return out


# ------------------------------------------------------------- cell result
@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float = 0.0
    error: str = ""
    memory: Optional[Dict] = None
    terms: Optional[Dict] = None
    model_flops: float = 0.0
    #: model FLOPs over the counted FLOPs of every card
    flops_ratio: float = 0.0
    peak_est: int = 0
    fits_hbm: bool = False
    microbatches: int = 1
    #: calls ``MeshOps`` repaired (``MeshOps.fallbacks``): ``"op
    #: (repair)"`` -> calls, in the cost run
    fallbacks: Optional[Dict] = None


def fallback_counts(counter) -> Dict[str, int]:
    """A :class:`~repro_torch.distributed.sharding.MeshOps`' fallbacks as
    ``{"op (plan)": calls}``, the most frequent first."""
    return {f"{op} ({plan})": n for (op, plan), n in counter.fallbacks.most_common()}


#: kv-block size for long-sequence prefill (memory-bounded attention path)
PREFILL_BLOCK_K = 4096
#: HBM budget for the auto-microbatch fit (leave headroom for allocator slack)
HBM_BUDGET = int(hw.HBM_BYTES * 0.95)


def _batch_shards(shape: ShapeConfig, mesh) -> int:
    n = 1
    sizes = _sizes(mesh)
    rem = shape.global_batch
    for a in ("pod", "data"):
        if a in sizes and rem % sizes[a] == 0 and rem >= sizes[a]:
            n *= sizes[a]
            rem //= sizes[a]
    return n


def _auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Initial microbatch guess: residual-carry activations <= ~2 GiB.

    mb is capped at local batch size: beyond that each microbatch's batch
    dim no longer spans the batch mesh axes and sharding degrades.
    """
    b_loc = max(shape.global_batch // _batch_shards(shape, mesh), 1)
    carry = cfg.num_groups * b_loc * shape.seq_len * cfg.d_model * 2
    mb = 1
    while carry / mb > 2 * 2**30 and mb < b_loc:
        mb *= 2
    return mb


# ------------------------------------------------------------ the counter
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense"}


def _tensors(x, out=None):
    """The tensors among ``x``'s items (nested lists, tuples and dicts)."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpBudgetExceeded(RuntimeError):
    """A cell dispatched more local ops than its budget allows."""


class _TripsIn(torch.autograd.Function):
    """The entry of a reckoned loop (:meth:`CellCounter.trips`): views of
    the shared inputs and the carried values.  Its backward runs once the
    trips' backward is done.  There it ends the counter's scaling, counts
    the accumulations of the trips' gradients of each shared input (the
    trips add them one by one, ``n - 1`` additions, while the earlier
    trips' tensors are still held), then drops the other trips' copies of
    what autograd held for them."""

    @staticmethod
    def forward(ctx, counter, n, n_shared, *xs):
        ctx.counter, ctx.n, ctx.n_shared = counter, n, n_shared
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        counter = ctx.counter
        counter._scale = counter._bwd_scales.pop()
        with counter.scaled(ctx.n - 1):  # the earlier trips' copies still live
            for g in grads[:ctx.n_shared]:
                if g is not None:  # the sum so far plus one trip's gradient
                    g + torch.empty_like(g)
        counter._drop_held()
        return (None, None, None, *grads)


class _TripsOut(torch.autograd.Function):
    """The exit of a reckoned loop: views of the last trip's carried
    values, which autograd keeps for the backward as it keeps every
    trip's.  Its backward starts the counter's scaling for the trips'
    backward."""

    @staticmethod
    def forward(ctx, counter, n, *carried):
        ctx.counter, ctx.n = counter, n
        ctx.save_for_backward(*carried)
        return tuple(t.view_as(t) for t in carried)

    @staticmethod
    def backward(ctx, *grads):
        counter = ctx.counter
        counter._bwd_scales.append(counter._scale)
        counter._scale = ctx.n
        return (None, None, *grads)


class CellCounter(RA.CollectiveCounter):
    """One rank's FLOPs, bytes, collectives and live local bytes while a
    step runs under it (see the module docstring).

    DTensor works out an op's output shapes by running it on fake tensors
    of the global shapes (the first time it meets the op on those
    placements); those runs pass through the mode too and are not counted:
    the step's own tensors are ``meta`` ones, so an op on fake tensors is
    DTensor's.

    The model hands a sequential loop's trips to :meth:`trips`
    (``distributed.sharding.loop_reckoner`` finds the counter), which runs
    one trip and counts it as all of them: the sLSTM walks 4,096 or 32,768
    tokens one at a time, millions of local ops.  With ``reckons_loops``
    false the model runs every trip under the counter."""

    reckons_loops = True

    def __init__(self, max_ops: int = 0):
        super().__init__()
        self.max_ops = max_ops
        self.ops = 0
        from torch.utils.flop_counter import flop_registry

        from ..kernels.spmv_ell import ops as ell_ops  # registers the op

        self._flops = dict(flop_registry)
        # the combine kernel: one add per partial it folds
        self._flops[torch.ops.repro_torch.segment_combine] = (
            lambda part, *a, out_val=None, **k: part.numel())
        del ell_ops
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._nbytes_of = {}
        #: what each counted op counts as: a reckoned loop's trips
        self._scale = 1
        self._bwd_scales = []
        #: storages made by the trip being reckoned; the bytes of the other
        #: trips' copies of a loop's list, by storage, and of what autograd
        #: holds for them, a loop each (see :meth:`trips`)
        self._trip_keys = None
        self._extra = {}
        self._held = []

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count each op inside as ``n`` ops (0: not at all)."""
        prev, self._scale = self._scale, n
        try:
            yield
        finally:
            self._scale = prev

    def trips(self, n: int, body, shared, carried):
        """Reckon ``n`` trips of a loop by running one: ``for _ in
        range(n): carried = body(*shared, *carried)``, where the caller
        keeps every trip's ``carried[0]`` in a list (the returned one ``n``
        times over; see :meth:`stacked`).  Returns the last trip's
        ``carried``.

        The trip's FLOPs, bytes and collectives count ``n`` times, in its
        backward too (:class:`_TripsIn`, :class:`_TripsOut`).  Memory: what
        the trip leaves alive counts once a trip, as each trip's own copy
        would: the tensors autograd keeps for the backward, the carried
        values it keeps with them, and the list; those copies count until
        the trips' backward is done (at each trip's backward the earlier
        trips' tensors are still held).  Without autograd (no gradients,
        or a checkpointed layer's first forward) a carried value counts
        once, but for the list's.  The caller reckons the
        loop's first and last trips by running them (their inputs and
        gradients then have the placements every other trip's have)."""
        k = len(shared)
        ins = _TripsIn.apply(self, n, k, *shared, *carried)
        prev, self._trip_keys = self._trip_keys, set()
        try:
            with self.scaled(n):
                out = body(*ins[:k], *ins[k:])
        finally:
            keys, self._trip_keys = self._trip_keys, prev
        self._hold(n, keys, out)
        return _TripsOut.apply(self, n, *out)

    def stacked(self, t) -> None:
        """The list of ``t``'s trips (:meth:`trips`) is stacked and gone:
        its copies stay only where autograd holds them."""
        self.live -= self._extra.pop(self._key(t), 0)

    @staticmethod
    def _key(t) -> int:
        return _local(t).untyped_storage()._cdata

    def _hold(self, n: int, keys, carried) -> None:
        """Count the trip's live storages ``n`` times (see :meth:`trips`).
        Where autograd holds the trip's tensors, the other trips' copies
        count until the trips' backward is done (the loops' backwards run
        last loop first); else only the list's copies of ``carried[0]``
        count, until it is stacked."""
        carried_keys = {self._key(t) for t in carried}
        alive = [k for k in keys if k in self._seen]
        listed = self._key(carried[0])
        if any(k not in carried_keys for k in alive):
            held = sum((n - 1) * self._nbytes_of[k] for k in alive)
            self._held.append(held)
            self.live += held
        elif listed in alive:
            self._extra[listed] = (n - 1) * self._nbytes_of[listed]
            self.live += self._extra[listed]
        self.peak = max(self.peak, self.live)

    def _drop_held(self) -> None:
        """The other trips' copies of what autograd held for the last loop
        are gone."""
        if self._held:
            self.live -= self._held.pop()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self._nbytes_of[key] = n
        if self._trip_keys is not None:
            self._trip_keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self._nbytes_of.pop(key, None)
        self.live -= n + self._extra.pop(key, 0)

    def adopt(self, tensors) -> int:
        """Count ``tensors`` (local ones) as already live, not as the step's
        temporaries: the arguments.  Returns their bytes."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self._seen:
                self._seen.add(st._cdata)
                total += st.nbytes()
        return total

    def _propagation(self, args) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        for t in args:
            if isinstance(t, FakeTensor):
                return True
            if isinstance(t, (list, tuple)):
                return self._propagation(t)
        return False

    def local_op(self, func, args, kwargs):
        if self._propagation(args):
            return func(*args, **kwargs)
        self.ops += 1
        if self.max_ops and self.ops > self.max_ops:
            raise OpBudgetExceeded(f"more than {self.max_ops} local ops in one run")
        scale = self._scale
        wire = self.stats if scale != 1 else None
        out = super().local_op(func, args, kwargs)
        if wire is not None:  # a collective of a reckoned trip: every trip's
            for kind, n in wire.bytes_by_kind.items():
                self.bytes_by_kind[kind] += (scale - 1) * (self.bytes_by_kind[kind] - n)
                self.count_by_kind[kind] += (scale - 1) * (
                    self.count_by_kind[kind] - wire.count_by_kind[kind])
        packet = func._overloadpacket
        name = packet._qualified_op_name.partition("::")[2]
        if RA.collective_kind(func) is not None or name in _NO_BYTES:
            return out
        outs = _tensors(out)
        f = self._flops.get(packet)
        if f is not None:
            self.flops += scale * int(f(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += scale * sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += scale * sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


# ------------------------------------------------------------- fake meshes
#: ranks of the fake process group: enough for every production mesh
FAKE_WORLD = 512


def fake_mesh(shape, axes):
    """A DeviceMesh of ``shape`` over the first ranks of a fake process
    group of :data:`FAKE_WORLD` ranks, this process rank 0.  The group is
    made once and kept: DTensor caches its sharding decisions by the
    mesh's shape, so a mesh over a group that was destroyed and made
    again would meet decisions that name the old group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(n, FAKE_WORLD))
    elif dist.get_backend() != "fake":
        raise RuntimeError("the dry run needs a process of its own: a "
                           f"{dist.get_backend()} group is running here")
    return make_model_mesh(shape, axes, device_type=default_mesh_type())


def _local(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ------------------------------------------------------------- cell lowering
def lower_cell(
    cfg: ModelConfig, shape: ShapeConfig, mesh, *,
    verbose: bool = True,
    microbatches: Optional[int] = None,  # None = auto-fit
    max_ops: int = 0,
) -> Tuple[None, Dict]:
    """Reckon one cell on ``mesh`` (a DeviceMesh over a fake group: see
    :func:`fake_mesh`) under :func:`pick_rules`' rules.  Returns
    ``(None, info)``, the reference's pair without a compiled artifact.

    Two runs, as the reference's two compiles: cost and collectives come
    from the ``microbatches=1`` run (the same math, one pass), memory from
    the run you would launch (the auto-fitted microbatch count, doubled
    while the peak exceeds ``HBM_BUDGET``).  Long prefill attends in kv
    blocks of ``PREFILL_BLOCK_K``.  ``max_ops`` (0: none) caps the local
    ops one run may dispatch: a cell past it fails with
    :class:`OpBudgetExceeded`.  The sLSTM's time loop is reckoned as one
    step counted once a token (:meth:`CellCounter.trips`).
    ``info["fallbacks"]`` counts the ops
    :class:`~repro_torch.distributed.sharding.MeshOps` repaired, by op."""
    rules = pick_rules(mesh, shape)
    attn_block_k = (PREFILL_BLOCK_K
                    if shape.mode == "prefill" and shape.seq_len > 2 * PREFILL_BLOCK_K
                    else 0)
    ctx = ShardingCtx(mesh=mesh, rules=rules, attn_impl="torch",
                      attn_block_k=attn_block_k)
    n_chips = int(mesh.size())

    def run_variant(mb: int) -> Dict:
        model = place_params(cfg, ctx)
        named = dict(model.named_parameters())
        batch = input_specs(cfg, shape)
        b_place = build_shardings(ctx, batch_specs_logical(cfg, batch), batch)
        counter = CellCounter(max_ops=max_ops)
        out = {}
        if shape.mode == "train":
            opt_dtype = (torch.bfloat16 if cfg.param_count > 100e9
                         else torch.float32)
            opt = adamw.init(named, opt_dtype)
            # the step places a plain batch by the rules (pick_rules'
            # batch axes divide it).  The memory run reckons two of its mb
            # microbatches: the
            # accumulators are whole from the start and each
            # microbatch's activations are gone before the next, so
            # the peak is inside one of them
            run_mb = min(mb, 2)
            step = make_train_step(cfg, ctx, adamw.AdamWConfig(),
                                   microbatches=run_mb)
            args = ([_local(p) for p in named.values()]
                    + [_local(t) for t in opt.m.values()]
                    + [_local(t) for t in opt.v.values()])
            arg_bytes = counter.adopt(args)
            arg_bytes += sum(_local_bytes(batch[k], b_place[k], mesh)
                             for k in batch)
            rows = shape.global_batch // mb * run_mb
            with ctx.scope(counter):
                _, _, _, metrics = step(model, opt, None,
                                        {k: v[:rows] for k, v in batch.items()})
                out["loss"] = metrics["loss"]
        else:
            from torch.distributed.tensor import distribute_tensor

            placed = {k: distribute_tensor(v, mesh, b_place[k],
                                           src_data_rank=None)
                      for k, v in batch.items()}
            args = [_local(p) for p in named.values()]
            args += [_local(t) for t in placed.values()]
            caches = None
            if shape.mode == "decode":
                max_seq = shape.seq_len + (
                    cfg.prefix_len if cfg.frontend == "vision_stub" else 0)
                caches = {
                    "stack": T.stacked_cache_init(cfg, shape.global_batch,
                                                  max_seq, device="meta"),
                    "memory": torch.zeros(
                        (shape.global_batch, cfg.encoder_seq, cfg.d_model),
                        dtype=torch.bfloat16, device="meta")
                    if cfg.encdec else None,
                }
                cache_logical = {
                    "stack": T.stacked_cache_specs(cfg),
                    "memory": ("batch", None, None) if cfg.encdec else None,
                }
                c_place = build_shardings(ctx, cache_logical, caches)
                caches = _place_tree(caches, c_place, mesh)
                args += [_local(t) for t in _leaves(caches)]
            arg_bytes = counter.adopt(args)
            with ctx.scope(counter), torch.no_grad():
                if shape.mode == "prefill":
                    logits, _ = M.prefill(model, placed, cfg, ctx)
                else:
                    logits, _ = M.decode_step(model, placed["tokens"], caches,
                                              shape.seq_len - 1, cfg, ctx)
                out["logits"] = logits
        out_bytes = sum(_nbytes(_local(t)) for t in out.values())
        return {
            "flops": counter.flops, "bytes": counter.bytes,
            "collectives": counter.stats,
            "argument_bytes": int(arg_bytes), "temp_bytes": int(counter.peak),
            "output_bytes": int(out_bytes),
            "fallbacks": fallback_counts(counter),
        }

    # ---- cost run (mb=1: one pass)
    t0 = time.time()
    cost = run_variant(1)

    # ---- memory run (the config you would run)
    mem = cost
    mb = 1
    if shape.mode == "train":
        mb = microbatches or _auto_microbatches(cfg, shape, mesh)
        mb_cap = max(shape.global_batch // _batch_shards(shape, mesh), 1)
        while True:
            mem = cost if mb == 1 else run_variant(mb)
            peak = mem["argument_bytes"] + mem["temp_bytes"]
            if peak <= HBM_BUDGET or mb * 2 > mb_cap or microbatches:
                break
            mb *= 2
    seconds = time.time() - t0
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    memory = {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
        "temp_bytes": mem["temp_bytes"],
        "peak_bytes": peak,
    }
    terms = RA.RooflineTerms(
        flops_per_dev=float(cost["flops"]),
        bytes_per_dev=float(cost["bytes"]),
        collective_bytes_per_dev=float(cost["collectives"].total_bytes),
        n_chips=n_chips,
    )
    mf = RA.model_flops(cfg, shape, shape.mode)
    counted = terms.flops_per_dev * n_chips
    if verbose:
        if cost["fallbacks"]:
            print(f"    fallbacks: {cost['fallbacks']}")
        print(f"    memory/dev: args={memory['argument_bytes'] / 2**30:.3f}GiB "
              f"temp={memory['temp_bytes'] / 2**30:.3f}GiB  (mb={mb})")
        print(f"    cost/dev: flops={terms.flops_per_dev:.4g} "
              f"bytes={terms.bytes_per_dev:.4g} "
              f"collective={terms.collective_bytes_per_dev:.4g}")
    info = {
        "seconds": seconds,
        "memory": memory,
        "peak_est": int(peak),
        "fits_hbm": bool(peak <= hw.HBM_BYTES),
        "microbatches": mb,
        "attn_block_k": attn_block_k,
        "n_chips": n_chips,
        "rules": {k: str(v) for k, v in rules.items()},
        "terms": terms.as_dict(),
        "collectives": dataclasses.asdict(cost["collectives"]),
        "model_flops_global": mf,
        "model_vs_counted_flops": mf / counted if counted else 0.0,
        "fallbacks": cost["fallbacks"],
    }
    return None, info


def place_params(cfg: ModelConfig, ctx: ShardingCtx) -> M.Model:
    """A :class:`Model` of bf16 ``meta`` DTensor parameters on ``ctx.mesh``,
    each under the placements :func:`build_shardings` gives its spec."""
    from ..distributed.sharding import distribute_module

    model = M.Model(cfg, device="meta", dtype=torch.bfloat16)
    named = dict(model.named_parameters())
    return distribute_module(model, ctx, build_shardings(ctx, M.param_specs(cfg),
                                                         named))


def _local_bytes(t: torch.Tensor, placements, mesh) -> int:
    """Bytes of rank 0's shard of ``t`` under ``placements``."""
    from torch.distributed.tensor import Shard

    shape = list(t.shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(d)
            shape[p.dim] = -(-shape[p.dim] // n)
    k = 1
    for s in shape:
        k *= s
    return k * t.element_size()


def _place_tree(tree, placements, mesh):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _place_tree(v, placements[k], mesh) if v is not None else None
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


# ------------------------------------------------------------------- graphmp
def lower_graphmp(mesh, workload: str = "eu-2015", verbose: bool = True) -> Dict:
    """Reckon the paper's own engine at billion-vertex scale: the port's
    distributed PageRank superstep (``core/distributed.py::
    make_superstep``) on one rank's share of ``device_graph_specs``'
    stand-ins.  The combine's order and the ``segment_combine`` kernel are
    ``torch.library`` custom ops with fake implementations, so the count
    sees the kernel's op at its true shapes."""
    import torch.distributed as dist

    from ..configs.graphmp import WORKLOADS
    from ..core.distributed import device_graph_specs, make_superstep

    w = WORKLOADS[workload]
    n_dev = int(mesh.size())
    rows_per_dev = -(-w.num_vertices // n_dev)
    specs = device_graph_specs(w.num_vertices, w.num_edges, n_dev)
    group = dist.new_group(list(range(n_dev)))  # the mesh's ranks
    step = make_superstep(group, "pagerank", w.num_vertices, rows_per_dev)
    t0 = time.time()
    names = ("src_vals", "ell_idx", "ell_valid", "seg", "out_deg")
    local = {k: torch.empty((specs[k].shape[0] // n_dev,) + tuple(specs[k].shape[1:]),
                            dtype=specs[k].dtype, device="meta") for k in names}
    counter = CellCounter()
    arg_bytes = counter.adopt(local.values())
    with counter:
        new_local, _ = step(*(local[k] for k in names))
    dt = time.time() - t0
    memory = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": _nbytes(new_local),
        "temp_bytes": int(counter.peak),
        "peak_bytes": int(arg_bytes + counter.peak),
    }
    terms = RA.RooflineTerms(
        flops_per_dev=float(counter.flops),
        bytes_per_dev=float(counter.bytes),
        collective_bytes_per_dev=float(counter.stats.total_bytes),
        n_chips=n_dev,
    )
    if verbose:
        print(f"    memory/dev: {memory}")
        print(f"    cost/dev: flops={terms.flops_per_dev:.4g} "
              f"bytes={terms.bytes_per_dev:.4g}")
        print(f"    collective bytes/dev: {terms.collective_bytes_per_dev:.4g}")
    return {
        "seconds": dt,
        "memory": memory,
        "peak_est": memory["peak_bytes"],
        "fits_hbm": bool(memory["peak_bytes"] <= hw.HBM_BYTES),
        "terms": terms.as_dict(),
        "collectives": dataclasses.asdict(counter.stats),
        "n_chips": n_dev,
        "workload": workload,
        "fallbacks": fallback_counts(counter),
    }


# ----------------------------------------------------------------------- CLI
#: the sweep's cap on one run's local ops (see ``lower_cell``)
SWEEP_MAX_OPS = 2_000_000


def run(arch: str, shape_names, mesh_kinds, out: Optional[str] = None,
        fail_fast: bool = False) -> list:
    results = []
    arch_list = configs.list_archs() if arch == "all" else [arch]

    for mesh_kind in mesh_kinds:
        mshape, axes = PRODUCTION_SHAPES[mesh_kind == "multi"]
        mesh = fake_mesh(mshape, axes)
        print(f"=== mesh {mesh_kind}: {_sizes(mesh)} ===")
        for a in arch_list:
            if a == "graphmp":
                continue
            cfg = configs.get_config(a)
            shapes = shape_names or configs.applicable_shapes(a)
            for sname in shapes:
                if sname not in configs.applicable_shapes(a):
                    print(f"  {a} x {sname}: SKIPPED (inapplicable, DESIGN.md §4)")
                    continue
                shape = SHAPES[sname]
                print(f"  {a} x {sname} [{shape.mode}] ...", flush=True)
                try:
                    _, info = lower_cell(cfg, shape, mesh, max_ops=SWEEP_MAX_OPS)
                    results.append(dataclasses.asdict(CellResult(
                        arch=a, shape=sname, mesh=mesh_kind, ok=True,
                        seconds=info["seconds"], memory=info["memory"],
                        terms=info["terms"],
                        model_flops=info["model_flops_global"],
                        flops_ratio=info["model_vs_counted_flops"],
                        peak_est=info["peak_est"], fits_hbm=info["fits_hbm"],
                        microbatches=info["microbatches"],
                        fallbacks=info["fallbacks"],
                    )))
                    print(f"    OK {info['seconds']:.1f}s "
                          f"peak_mem/dev={info['peak_est'] / 2**30:.2f}GiB",
                          flush=True)
                except Exception as e:
                    traceback.print_exc()
                    results.append(dataclasses.asdict(CellResult(
                        arch=a, shape=sname, mesh=mesh_kind, ok=False,
                        error=f"{type(e).__name__}: {e}"[:500],
                    )))
                    if fail_fast:
                        raise
        if arch in ("all", "graphmp"):
            print("  graphmp x eu-2015 [superstep] ...", flush=True)
            try:
                info = lower_graphmp(mesh)
                results.append(dataclasses.asdict(CellResult(
                    arch="graphmp", shape="eu-2015", mesh=mesh_kind, ok=True,
                    seconds=info["seconds"], memory=info["memory"],
                    terms=info["terms"], peak_est=info["peak_est"],
                    fits_hbm=info["fits_hbm"], fallbacks=info["fallbacks"],
                )))
            except Exception as e:
                traceback.print_exc()
                results.append(dataclasses.asdict(CellResult(
                    arch="graphmp", shape="eu-2015", mesh=mesh_kind,
                    ok=False, error=f"{type(e).__name__}: {e}"[:500],
                )))
                if fail_fast:
                    raise

    n_ok = sum(r["ok"] for r in results)
    print(f"\n==== dry-run: {n_ok}/{len(results)} cells reckoned ====")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {out}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default=None,
                    help="comma-separated shape names (default: all applicable)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)
    shapes = args.shape.split(",") if args.shape else None
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run(args.arch, shapes, meshes, out=args.out,
                  fail_fast=args.fail_fast)
    if not all(r["ok"] for r in results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
