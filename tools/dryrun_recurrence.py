#!/usr/bin/env python3
"""The sLSTM recurrence's share of the xLSTM dry-run cells' FLOPs.

    PYTHONPATH=src python tools/dryrun_recurrence.py [single|multi] [SHAPE ...]

Reckons ``xlstm-350m``'s cells (default ``prefill_32k train_4k``) on a
production mesh as ``python -m repro_torch.launch.dryrun`` does, and
splits one card's FLOPs into the sLSTM time loop's (the steps the counter
reckons, ``CellCounter.trips``, scaled to all S steps) and the rest.  XLA's
cost analysis, which the reference's dry run reads, counts a ``lax.scan``
body once (``tests/test_torch_dryrun_slstm.py``), and the reference
corrects only its layer-group scan (``repro/launch/dryrun.py``,
``corrected_terms``), so its figure for these cells carries the
recurrence once: the port's FLOPs less (S - 1) / S of the recurrence's.
Prints one ``RECURRENCE {...}`` line a cell.  On the CPU, on ``meta``
tensors: minutes a cell.
"""

import json
import sys

from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import PRODUCTION_SHAPES


class _Counter(DR.CellCounter):
    """The dry run's counter, also summing the FLOPs of reckoned trips."""

    runs = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.trip_flops = 0
        _Counter.runs.append(self)

    def local_op(self, func, args, kwargs):
        before, scaled = self.flops, self._scale > 1
        out = super().local_op(func, args, kwargs)
        if scaled:
            self.trip_flops += self.flops - before
        return out


def main(argv) -> int:
    mesh_kind = argv[0] if argv else "single"
    shapes = argv[1:] or ["prefill_32k", "train_4k"]
    DR.CellCounter = _Counter
    cfg = configs.get_config("xlstm-350m")
    mshape, axes = PRODUCTION_SHAPES[mesh_kind == "multi"]
    mesh = DR.fake_mesh(mshape, axes)
    for name in shapes:
        shape = SHAPES[name]
        _Counter.runs.clear()
        _, info = DR.lower_cell(cfg, shape, mesh, verbose=False, max_ops=DR.SWEEP_MAX_OPS)
        cost = _Counter.runs[0]  # the cost run (one microbatch)
        S = shape.seq_len
        total = info["terms"]["flops_per_dev"]
        # the first and last steps run unscaled: count them with the rest
        recurrence = cost.trip_flops * S / (S - 2)
        print("RECURRENCE " + json.dumps({
            "arch": cfg.name, "shape": name, "mesh": mesh_kind,
            "flops_per_dev": total, "recurrence_flops_per_dev": recurrence,
            "recurrence_share": recurrence / total,
            "flops_with_recurrence_once": total - recurrence * (S - 1) / S,
            "model_flops_global": info["model_flops_global"],
            "n_chips": info["n_chips"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
