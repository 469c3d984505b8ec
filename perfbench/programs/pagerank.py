"""``pagerank``: every request is one run of the paper's PageRank of
``iterations`` steps (damping ``damping``) from its initial values.

Compared: ``max_rel_err``, the largest ``|x - ref| / ref`` over every
vertex of every answer, against float64 after the requested steps (a run
that stopped early is right only where its values no longer moved).
Control: the reference with values and messages stored in bfloat16.
"""

import dataclasses

import numpy as np
import torch

from perfbench import mixes
from perfbench.reference import graph as ref


class Program(mixes.Mix):
    def _program(self):
        from repro_torch.core import apps

        return apps.pagerank(self.traffic["damping"])

    def warm_up(self, engine) -> None:
        # the first run puts every shard on the card
        self.request(engine, 0)

    def request(self, engine, i: int):
        r = engine.run(self._program(), max_iters=self.traffic["iterations"])
        return mixes.Answer(0, r.values, r.converged), r

    def compare(self, answers, src, dst, n, control=False):
        d, steps = self.traffic["damping"], self.traffic["iterations"]
        limit = self.limits["max_rel_err"]
        want = ref.pagerank(src, dst, n, d, steps).cpu().numpy()
        if control:
            low = ref.pagerank(src, dst, n, d, steps,
                               store_dtype=torch.bfloat16).cpu().numpy()
            answers = [dataclasses.replace(a, values=low) for a in answers]
        worst, failed = 0.0, 0
        for a in answers:
            err = float(np.max(np.abs(a.values.astype(np.float64) - want) / want))
            if not np.isfinite(err):
                err = float("inf")
            worst = max(worst, err)
            failed += err > limit
        return [mixes.Compared("max_rel_err", worst, limit, failed)]
