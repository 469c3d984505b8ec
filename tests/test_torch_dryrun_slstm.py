"""The dry run's reckoning of the sLSTM's time loop, on the CPU.

Under the dry run's counter (``launch/dryrun.py::CellCounter``) the sLSTM
runs its first and last time steps and reckons the steps between as one
step counted S - 2 times (``CellCounter.trips``), where every other run
walks every token.  On the xLSTM smoke config, small enough for the
counter to walk every token too, the reckoned cell's FLOPs, bytes,
collective bytes, temporaries and peak equal the walked cell's within 1%:
a train cell (forward, the checkpointed layers' recomputation and the
backward) and a prefill cell on a (2, 4) fake mesh, and a train cell on a
(1, 8) mesh, whose ``model`` axis is wider than the config's 4 heads (the
head views of the sLSTM's output and the mLSTM's head norm in the
backward).  A cell whose token-by-token loop alone passes the op budget,
which the dry run once refused before running it, now returns its terms.
The reference's figure for the same cells reads XLA's cost analysis,
which counts a ``lax.scan`` body once whatever its trip count (the last
test), so it carries the sLSTM's recurrence once
(``tools/dryrun_recurrence.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro_torch import configs
from repro_torch.config import ShapeConfig, smoke_config
from repro_torch.launch import dryrun as DR

#: the removed up-front refusal's estimate: local ops an sLSTM time step
#: dispatches in a forward (a train step runs it about four times)
OLD_STEP_OPS = 30


def _cfg():
    return smoke_config(configs.get_config("xlstm-350m"))


def _terms(info):
    return {"flops": info["terms"]["flops_per_dev"],
            "bytes": info["terms"]["bytes_per_dev"],
            "collective_bytes": info["terms"]["collective_bytes_per_dev"],
            "temp_bytes": info["memory"]["temp_bytes"],
            "peak": info["peak_est"]}


@pytest.mark.parametrize("mesh_shape,mode", [((2, 4), "train"), ((2, 4), "prefill"),
                                             ((1, 8), "train")],
                         ids=["2x4-train", "2x4-prefill", "1x8-train"])
def test_reckoned_slstm_loop_equals_the_walked_loop(mesh_shape, mode, monkeypatch):
    cfg = _cfg()
    assert any(cfg.layer_kind(i)[0] == "slstm" for i in range(cfg.num_layers))
    mesh = DR.fake_mesh(mesh_shape, ("data", "model"))
    shape = ShapeConfig(f"{mode}_64", 64, 8, mode)
    got = {}
    for reckon in (False, True):
        monkeypatch.setattr(DR.CellCounter, "reckons_loops", reckon)
        _, info = DR.lower_cell(cfg, shape, mesh, verbose=False, microbatches=1)
        got[reckon] = _terms(info)
    walked, reckoned = got[False], got[True]
    for k, want in walked.items():
        assert want > 0, k
        assert abs(reckoned[k] - want) <= 0.01 * want, (k, reckoned[k], want)
    if mesh_shape == (2, 4):
        assert walked["collective_bytes"] > 0


def test_a_cell_past_the_old_op_cap_returns_its_terms(monkeypatch):
    """The old rule refused the cell before running it (its sLSTM layers'
    steps alone estimated past ``max_ops``); walking every token does pass
    the cap, and the reckoned loop stays under it."""
    cfg = dataclasses.replace(_cfg(), ssm_chunk=512)
    mesh = DR.fake_mesh((2, 4), ("data", "model"))
    shape = ShapeConfig("prefill_1k", 1024, 8, "prefill")
    max_ops = 30_000
    n_slstm = sum(cfg.layer_kind(i)[0] == "slstm" for i in range(cfg.num_layers))
    assert n_slstm * shape.seq_len * OLD_STEP_OPS > max_ops
    with monkeypatch.context() as m:
        m.setattr(DR.CellCounter, "reckons_loops", False)
        with pytest.raises(DR.OpBudgetExceeded):
            DR.lower_cell(cfg, shape, mesh, verbose=False, max_ops=max_ops)
    _, info = DR.lower_cell(cfg, shape, mesh, verbose=False, max_ops=max_ops)
    assert info["terms"]["flops_per_dev"] > 0 and info["peak_est"] > 0


def test_xla_cost_analysis_counts_a_scan_body_once():
    """A scan of one [8, 128] x [128, 128] matmul a trip costs one trip's
    flops in XLA's cost analysis at 1 and at 4,096 trips."""

    def flops(trips):
        def f(h, w):
            return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), h, None,
                                length=trips)[0]
        cost = jax.jit(f).lower(jnp.zeros((8, 128)), jnp.zeros((128, 128))).compile()
        cost = cost.cost_analysis()
        return (cost[0] if isinstance(cost, list) else cost)["flops"]

    one_trip = 2 * 8 * 128 * 128
    assert one_trip <= flops(1) < 1.01 * one_trip
    assert one_trip <= flops(4096) < 1.01 * one_trip
