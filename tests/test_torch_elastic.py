"""Elastic scaling on model meshes: the port's counterpart of
``tests/test_elastic.py``, over ``torch.distributed`` gloo ranks (child
processes, one rank each, ``file://`` rendezvous in the test's tmp dir).

- 8 ranks place the widened qwen2.5-3b smoke parameters (d_model 64,
  d_ff 128) on a (2, 4) ``("data", "model")`` mesh, checkpoint them with
  the port's ``Checkpointer`` (every rank joins the gathers, rank 0 alone
  keeps and writes the whole leaves), and restore onto (4, 2); 2 ranks
  restore the same checkpoint onto (1, 2).  Every rank's shard of every
  restored leaf is bitwise its part of the saved leaf, and a DTensor of
  the new mesh.
- A checkpoint the reference package wrote (its ``Checkpointer``, its
  parameter tree) restores onto a port (2, 4) mesh, bitwise.
- One train step of the yi-6b smoke config (f32 activations; and of the
  phi3.5-moe one) on a (2, 2) mesh of 4 ranks against the unsharded step
  from the same parameters,
  moments and batch:
  loss and ``grad_norm`` within rtol 1e-4, and each parameter, ``m`` and
  ``v`` change within ``tests/test_torch_train.py``'s f32 tolerance
  (``delta`` 1e-3 of the leaf's largest change, plus 2 ulps); without
  compression and with top-k compression (one threshold over each whole
  logical leaf, as the reference takes it over each stacked leaf).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

RANK = textwrap.dedent(
    """
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, rdzv, work, phase = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.config import smoke_config
    from repro_torch.distributed.fault_tolerance import elastic_reshard
    from repro_torch.distributed.sharding import SINGLE_POD_RULES, ShardingCtx
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import reference_specs, reference_tree

    def ctx_for(shape):
        mesh = make_model_mesh(shape, ("data", "model"), device_type="cpu")
        return ShardingCtx(mesh=mesh, rules=dict(SINGLE_POD_RULES), attn_impl="torch")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield "/".join(path + (k,)), v

    def shard_of(arr, leaf):
        # this rank's part of the whole array: torch.chunk along each
        # sharded dim, mesh dims in order (DTensor's Shard semantics)
        t = torch.from_numpy(arr)
        coord = leaf.device_mesh.get_coordinate()
        for d, p in enumerate(leaf.placements):
            if p.is_shard():
                t = torch.chunk(t, leaf.device_mesh.size(d), dim=p.dim)[coord[d]]
        return t.numpy()

    def check(restored, want, shape, tag):
        # every rank's shard against its part of the saved leaf: no
        # collective, so the check costs nothing on a loaded machine
        n = 0
        for name, leaf in leaves(restored):
            assert isinstance(leaf, DTensor), (tag, name)
            assert tuple(leaf.device_mesh.shape) == shape, (tag, name)
            assert tuple(leaf.shape) == want[name].shape, (tag, name)
            got, part = leaf.to_local().numpy(), shard_of(want[name], leaf)
            assert got.dtype == part.dtype and np.array_equal(got, part), (tag, name)
            n += 1
        if rank == 0:
            print(tag, "OK", n, flush=True)

    if phase in ("place", "shrink"):
        cfg = smoke_config(configs.get_config("qwen2.5-3b"))
        cfg = dataclasses.replace(cfg, d_model=64, d_ff=128)
        model = M.init_params(0, cfg, dtype=torch.float32, device="cpu")
        named = {n: p.detach() for n, p in model.named_parameters()}
        whole = {k: v.numpy() for k, v in leaves(reference_tree(named, cfg))}
        specs = reference_specs(M.param_specs(cfg), cfg)
        like = reference_tree(named, cfg, device="meta")
        ck = Checkpointer(work + "/ck")
        if phase == "place":
            placed = elastic_reshard(named, M.param_specs(cfg), ctx_for((2, 4)))
            assert all(tuple(t.device_mesh.shape) == (2, 4) for t in placed.values())
            # every rank joins the gathers, rank 0 alone keeps the tree
            tree = reference_tree(placed, cfg, device="cpu", keep=rank == 0)
            assert (tree is None) == (rank != 0)
            if rank == 0:
                ck.save(1, tree)
            dist.barrier()
            check(elastic_reshard(ck.restore(1, like), specs, ctx_for((4, 2))),
                  whole, (4, 2), "RESHARD_4x2")
            # the reference package's checkpoint of its own parameter tree
            ref = dict(np.load(work + "/ref_params.npz"))
            check(elastic_reshard(Checkpointer(work + "/ref_ck").restore(1, like),
                                  specs, ctx_for((2, 4))),
                  ref, (2, 4), "REFERENCE_2x4")
        else:
            check(elastic_reshard(ck.restore(1, like), specs, ctx_for((1, 2))),
                  whole, (1, 2), "RESHARD_1x2")
    else:  # one train step of the yi-6b smoke config on (2, 2)
        from repro_torch.data.tokens import DataConfig, make_batch
        from repro_torch.distributed.sharding import distribute_module
        from repro_torch.optim import adamw
        from repro_torch.optim.compression import CompressionConfig, init_error_state
        from repro_torch.train.step import make_train_step

        from repro_torch.models import common as C

        # f32 activations, as tests/test_torch_train.py's f32 tolerance has
        # them: bf16 rounds the shards' partial sums differently
        bf16_embed = C.embed
        C.embed = lambda p, t, dtype=None: bf16_embed(p, t, torch.float32)
        cfg = smoke_config(configs.get_config(sys.argv[7]))
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
        batch = make_batch(DataConfig(seq_len=16, global_batch=4,
                                      vocab_size=cfg.vocab_size, seed=3), 0)

        def state_for(model):
            named = dict(model.named_parameters())
            st = adamw.init(named)
            gen = torch.Generator().manual_seed(5)
            for n in named:  # the step-3 moments of tests/test_torch_train.py
                st.m[n].copy_(torch.randn(named[n].shape, generator=gen) * 1e-4)
                st.v[n].copy_(1e-4 * (1 + torch.rand(named[n].shape, generator=gen)))
            st.step = 3
            return st

        def run(ctx, compression=None):
            model = M.init_params(1, cfg, dtype=torch.float32, device="cpu")
            st = state_for(model)
            base = {k: {n: t.detach().clone() for n, t in d.items()}
                    for k, d in (("params", dict(model.named_parameters())),
                                 ("m", st.m), ("v", st.v))}
            if ctx.mesh is not None:
                place = ctx.param_sharding(M.param_specs(cfg))
                distribute_module(model, ctx, place)
                named = dict(model.named_parameters())
                st.m = elastic_reshard(st.m, M.param_specs(cfg), ctx)
                st.v = elastic_reshard(st.v, M.param_specs(cfg), ctx)
            step = make_train_step(cfg, ctx, opt, compression=compression)
            err = init_error_state(dict(model.named_parameters())) if compression else None
            model, st, _, met = step(model, st, err, batch)
            full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
            after = {k: {n: full(t.detach()).numpy() for n, t in d.items()}
                     for k, d in (("params", dict(model.named_parameters())),
                                  ("m", st.m), ("v", st.v))}
            return met, after, base

        comp = CompressionConfig(sys.argv[6]) if sys.argv[6] != "none" else None
        met, after, base = run(ctx_for((2, 2)), comp)
        umet, uafter, _ = run(ShardingCtx(attn_impl="torch"), comp)
        if rank == 0:
            np.savez(work + f"/step_{sys.argv[6]}.npz",
                     **{f"mesh/{k}/{n}": a for k, d in after.items() for n, a in d.items()},
                     **{f"one/{k}/{n}": a for k, d in uafter.items() for n, a in d.items()},
                     **{f"base/{k}/{n}": t.numpy() for k, d in base.items()
                        for n, t in d.items()},
                     metrics=np.array([float(met["loss"]), float(met["grad_norm"]),
                                       float(umet["loss"]), float(umet["grad_norm"])]))
            print("STEP_OK", flush=True)
    dist.destroy_process_group()
    """
)


def _launch(world, tmp_path, phase, extra="none", arch="yi-6b", timeout=600):
    rdzv = tmp_path / f"rdzv_{phase}_{extra}"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(world),
                               str(rdzv), str(tmp_path), phase, extra, arch],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (phase, out[-1500:], err[-3000:])
    return outs[0][0]


def _write_reference_checkpoint(tmp_path):
    """The reference's parameters of the same config, written by the
    reference's Checkpointer (and kept as npz for the comparison)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as rc
    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
    from repro.checkpoint.checkpointer import _flatten_with_names
    from repro.config import smoke_config as ref_smoke
    from repro.models import model as RM

    cfg = dataclasses.replace(ref_smoke(rc.get_config("qwen2.5-3b")), d_model=64,
                              d_ff=128)
    params = RM.init_params(jax.random.key(7), cfg, dtype=jnp.float32)
    RefCheckpointer(str(tmp_path / "ref_ck")).save(1, params)
    np.savez(tmp_path / "ref_params.npz",
             **{n: np.asarray(x) for n, x in _flatten_with_names(params)})


def test_checkpoint_restores_across_mesh_shapes(tmp_path):
    _write_reference_checkpoint(tmp_path)
    out = _launch(8, tmp_path, "place")
    assert "RESHARD_4x2 OK" in out and "REFERENCE_2x4 OK" in out
    out = _launch(2, tmp_path, "shrink")
    assert "RESHARD_1x2 OK" in out


@pytest.mark.parametrize("compression", ["none", "topk"])
def test_train_step_on_a_2x2_mesh_matches_the_unsharded_step(tmp_path, compression):
    """With top-k compression the threshold is over each whole logical
    leaf (a collective gathers it), so the mesh keeps the same entries."""
    _check_step(tmp_path, compression, "yi-6b")


def test_moe_train_step_on_a_2x2_mesh_matches_the_unsharded_step(tmp_path):
    """A MoE config: each rank routes, dispatches and combines its own
    batch rows, and the router's gradient is their partial sums reduced
    over the data axis; the experts are split over the model axis."""
    _check_step(tmp_path, "none", "phi3.5-moe-42b-a6.6b")


def _check_step(tmp_path, compression, arch):
    out = _launch(4, tmp_path, "step", compression, arch)
    assert "STEP_OK" in out
    z = np.load(tmp_path / f"step_{compression}.npz")
    loss, gnorm, uloss, ugnorm = z["metrics"]
    assert np.isclose(loss, uloss, rtol=1e-4, atol=0), (loss, uloss)
    assert np.isclose(gnorm, ugnorm, rtol=1e-4, atol=0), (gnorm, ugnorm)
    names = [k[len("one/"):] for k in z.files if k.startswith("one/")]
    assert names
    for n in names:
        got, want = z[f"mesh/{n}"], z[f"one/{n}"]
        kind = n.split("/")[0]
        base = z[f"base/{n}"] * {"params": 1.0, "m": 0.9, "v": 0.95}[kind]
        change = np.abs(want - base.astype(np.float32)).max()
        err = np.abs(got - want) - 2 * np.spacing(np.abs(want))
        assert (err <= 1e-3 * change).all(), (n, float(err.max()), float(change))
