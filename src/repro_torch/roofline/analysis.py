"""Roofline analysis of a dry-run cell on the H100.

Three terms per (arch x shape x mesh), in seconds, as in the reference:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

The dry run (``launch/dryrun.py``) reckons the per-device FLOPs, bytes and
collective bytes of one rank while the step runs on fake tensors.  There
is no HLO text in PyTorch: :class:`CollectiveCounter` counts the
collectives that are actually dispatched (``_c10d_functional`` ops, which
DTensor's redistributions issue, and the ``c10d`` ops of
``torch.distributed``'s own calls), each on the rank's local tensors.

**No scan correction.**  The reference's ``corrected_terms`` exists
because an XLA ``scan`` body is counted once however many trips it runs.
Every loop of the port is a Python loop that dispatches every trip's
operations: the layer stack (``models/transformer.py::run_stack`` and the
encoder's), the SSD and mLSTM chunk carry (``models/ssm.py::
chunked_linear_rnn``, one trip a chunk), the sLSTM's time steps
(``slstm_block``, one a token), the kv-block loop of blocked attention
(``models/attention.py::blocked_attention``) and the microbatch loop of
the train step.  So every trip is counted, and the port has no
``corrected_terms``.  Nor does it need the reference's analytic attention
correction for blocked prefill: the kv-block loop's einsums are counted.
:func:`attention_analytic` stays, for comparison with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..distributed.sharding import MeshOps
from . import hw

__all__ = ["COLLECTIVES", "CollectiveStats", "CollectiveCounter", "RooflineTerms",
           "attention_analytic", "model_flops"]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


#: dispatched op name -> (kind, which side's bytes cross the wire).
#: The wire convention is the reference's ``parse_collectives`` docstring:
#: what lands on each device for an all-gather, an all-reduce, an
#: all-to-all and a permute (their outputs), what leaves it for a
#: reduce-scatter (its input).  The reference's parser counts a
#: reduce-scatter's output (its code departs from its docstring there);
#: the port follows the docstring.  Nothing in the port dispatches a
#: point-to-point permute, so ``collective-permute`` stays 0.
_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "allgather_": ("all-gather", "out"),
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "allreduce_": ("all-reduce", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "reduce_scatter_": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", "out"),
    "alltoall_": ("all-to-all", "out"),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _group_size(args) -> int:
    """The size of the group a collective runs on (its group name, a
    string, or its process group object, among the arguments)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return _resolve_process_group(a).size()
            except Exception:
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    return 0


def collective_kind(func):
    """``(kind, side)`` of a dispatched collective op, else None."""
    packet = getattr(func, "_overloadpacket", None)
    if packet is None:
        return None
    ns, _, name = packet._qualified_op_name.partition("::")
    if ns not in _NAMESPACES:
        return None
    return _OPS.get(name)


class CollectiveCounter(MeshOps):
    """A :class:`~repro_torch.distributed.sharding.MeshOps` that counts the
    collectives this rank dispatches, bytes and calls by the reference's
    five kinds.  Bytes are of the rank's local tensors: an all-gather's
    output is the gathered tensor.  A collective over one rank moves
    nothing and is not counted."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind = {k: 0 for k in COLLECTIVES}
        self.count_by_kind = {k: 0 for k in COLLECTIVES}

    def local_op(self, func, args, kwargs):
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind is not None and _group_size(args) != 1:  # one rank: no wire
            k, side = kind
            if side == "out":
                # c10d's in-place ops write into their first argument
                wire = args[0] if func._overloadpacket._qualified_op_name.startswith(
                    "c10d::") else out
            else:
                wire = args[1] if func._overloadpacket._qualified_op_name.startswith(
                    "c10d::") and len(args) > 1 else args[0]
            self.bytes_by_kind[k] += _nbytes(wire)
            self.count_by_kind[k] += 1
        return out

    @property
    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_kind), dict(self.count_by_kind))


@dataclasses.dataclass
class RooflineTerms:
    flops_per_dev: float
    bytes_per_dev: float
    collective_bytes_per_dev: float
    n_chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_dev / hw.NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound (sum) — conservative."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def step_time_overlap_s(self) -> float:
        """Perfect-overlap lower bound (max)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "collective_bytes_per_dev": self.collective_bytes_per_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "n_chips": self.n_chips,
        }


def attention_analytic(cfg, shape, mode: str) -> Tuple[float, float]:
    """Global (flops, bytes) of causal self-attention einsums.

    fwd flops per layer = 4 * B * H * pairs * head_dim  (QK^T + AV);
    train multiplies by 4 (forward + remat re-forward + 2x backward).
    The reference adds this to blocked-prefill cells, whose kv loop its
    cost analysis counts once; the port counts that loop trip by trip.
    """
    S, B = shape.seq_len, shape.global_batch
    H, hd = cfg.num_heads, cfg.head_dim
    n_attn = sum(
        1 for i in range(cfg.num_layers) if cfg.layer_kind(i)[0] == "attn"
    )
    pairs = S * (S + 1) / 2  # causal
    mult = 4.0 if mode == "train" else 1.0
    flops = 4.0 * B * H * pairs * hd * n_attn * mult
    # bytes: q/k/v/o streamed once per layer (blocked path keeps q resident)
    byts = B * S * hd * (2 * H + 2 * cfg.num_kv_heads) * 2 * n_attn * mult
    return flops, byts


def model_flops(cfg, shape, mode: str) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D forward (N = active params).

    For decode, D = tokens processed per step (= global_batch)."""
    n = cfg.active_param_count
    if mode == "train":
        d = shape.seq_len * shape.global_batch
        return 6.0 * n * d
    if mode == "prefill":
        d = shape.seq_len * shape.global_batch
        return 2.0 * n * d
    d = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * d
