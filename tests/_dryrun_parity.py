"""Shared helpers of the dry-run parity tests (not a test module).

The reference side runs in a child process with
``--xla_force_host_platform_device_count=8`` and a (2, 4) mesh whose axes
are ``Auto``: the installed JAX's ``jax.make_mesh`` defaults to
``Explicit`` axes, which the reference's ``with_sharding_constraint``
rejects.  Nothing in ``src/repro`` changes for that.  The child prints one
JSON object: every leaf's ``NamedSharding.shard_shape`` and item size
(parameters, batch, decode caches), ``model_flops`` per cell, the
reference's ``pick_rules`` on stand-in production meshes, and on request
XLA's ``memory_analysis().argument_size_in_bytes`` of a train cell.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

#: the cells of tests/test_dryrun_small.py
TRAIN = ("train_tiny", 64, 8, "train")
DECODE = ("decode_tiny", 128, 8, "decode")

REF_SCRIPT = textwrap.dedent(
    """
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    # after the backend holds its 8 devices: the module sets XLA_FLAGS
    from repro.launch import dryrun as DR
    from repro import configs
    from repro.config import SHAPES, ShapeConfig, smoke_config
    from repro.distributed.sharding import ShardingCtx
    from repro.models import model as M, transformer as T
    from repro.roofline import analysis as RA

    arch, want_xla = sys.argv[1], sys.argv[2] == "1"
    cfg = smoke_config(configs.get_config(arch))
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256,
                              dense_d_ff=256 if cfg.dense_d_ff else 0)

    def leaves(tree, shard):
        out = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        sflat = jax.tree_util.tree_leaves(shard)
        for (path, sds), sh in zip(flat, sflat):
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            out[name] = [list(sh.shard_shape(sds.shape)), jnp.dtype(sds.dtype).itemsize]
        return out

    res = {"cells": {}}
    for name, seq, batch, mode in (%s, %s):
        shape = ShapeConfig(name, seq, batch, mode)
        ctx = ShardingCtx(mesh=mesh, rules=DR.pick_rules(mesh, shape), attn_impl="xla")
        params_sh = jax.eval_shape(
            lambda: M.init_params(jax.random.key(0), cfg, dtype=jnp.bfloat16))
        cell = {"params": leaves(params_sh, DR.build_shardings(
            ctx, M.param_specs(cfg), params_sh))}
        b = DR.input_specs(cfg, shape)
        cell["batch"] = leaves(b, DR.build_shardings(
            ctx, DR.batch_specs_logical(cfg, b), b))
        if mode == "decode":
            caches = jax.eval_shape(
                lambda: M.init_decode_caches(cfg, shape.global_batch, shape.seq_len))
            logical = {"stack": T.stacked_cache_specs(cfg),
                       "memory": ("batch", None, None) if cfg.encdec else None}
            cell["caches"] = leaves(caches, DR.build_shardings(ctx, logical, caches))
        cell["model_flops"] = RA.model_flops(cfg, shape, mode)
        if want_xla and mode == "train":
            _, info = DR.lower_cell(cfg, shape, mesh, verbose=False, microbatches=1,
                                    with_outer_correction=False)
            cell["xla_argument_bytes"] = info["memory"]["argument_bytes"]
        res["cells"][name] = cell

    class Stand:
        def __init__(self, shape, axes):
            self.axis_names = axes
            self.devices = type("D", (), {"shape": shape})()

    res["rules"] = {}
    for multi in (False, True):
        shp, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else (
            (16, 16), ("data", "model"))
        for sname, shape in SHAPES.items():
            r = DR.pick_rules(Stand(shp, axes), shape)
            res["rules"][f"{multi}/{sname}"] = {k: v for k, v in r.items()}
    print("REF_JSON" + json.dumps(res))
    """ % (repr(TRAIN), repr(DECODE))
)


def reference(arch: str, want_xla: bool = False) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, arch, "1" if want_xla else "0"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("REF_JSON"))
    return json.loads(line[len("REF_JSON"):])


def widened(arch: str):
    from repro_torch import configs
    from repro_torch.config import smoke_config

    cfg = smoke_config(configs.get_config(arch))
    return dataclasses.replace(cfg, d_model=128, d_ff=256,
                               dense_d_ff=256 if cfg.dense_d_ff else 0)


def shape_of(cell):
    from repro_torch.config import ShapeConfig

    return ShapeConfig(*cell)


def port_leaves(cfg, cell, mesh):
    """The port's rank-0 local shapes and item sizes in the reference's
    layout: ``{"params", "batch"[, "caches"]}`` -> path -> [shape, size]."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import transformer as T
    from repro_torch.models.params import reference_groups, reference_path
    from repro_torch.distributed.sharding import ShardingCtx

    shape = shape_of(cell)
    ctx = ShardingCtx(mesh=mesh, rules=DR.pick_rules(mesh, shape))
    named = dict(DR.place_params(cfg, ctx).named_parameters())
    params = {}
    for path, names in reference_groups(named, cfg).items():
        p = named[names[0]]
        local = list(p.to_local().shape)
        stacked = reference_path(names[0], cfg)[1] is not None
        params["/".join(path)] = [[len(names)] + local if stacked else local,
                                  p.element_size()]
    batch = DR.input_specs(cfg, shape)
    place = DR.build_shardings(ctx, DR.batch_specs_logical(cfg, batch), batch)
    out = {"params": params,
           "batch": {k: [_local_shape(v, place[k], mesh), v.element_size()]
                     for k, v in batch.items()}}
    if shape.mode == "decode":
        caches = {"stack": T.stacked_cache_init(cfg, shape.global_batch, shape.seq_len,
                                                device="meta"),
                  "memory": None}
        logical = {"stack": T.stacked_cache_specs(cfg), "memory": None}
        cp = DR.build_shardings(ctx, logical, caches)
        out["caches"] = {
            f"stack/{j}/{n}": [_local_shape(t, cp["stack"][j][n], mesh), t.element_size()]
            for j, d in caches["stack"].items() for n, t in d.items()}
    return out


def _local_shape(t, placements, mesh):
    from torch.distributed.tensor import Shard

    shape = list(t.shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // mesh.size(d))
    return shape


def nbytes(leaves: dict, itemsize=None) -> int:
    total = 0
    for shape, size in leaves.values():
        n = 1
        for s in shape:
            n *= s
        total += n * (itemsize or size)
    return total


_CELLS = {}


def cell_info(arch, cell, ms):
    """``lower_cell``'s info for ``arch`` x ``cell`` on an ``ms`` fake mesh
    (microbatches 1), reckoned once per process."""
    from repro_torch.launch import dryrun as DR

    key = (arch, cell, ms)
    if key not in _CELLS:
        mesh = DR.fake_mesh(ms, ("data", "model"))
        _CELLS[key] = DR.lower_cell(widened(arch), shape_of(cell), mesh,
                                    verbose=False, microbatches=1)[1]
    return _CELLS[key]


def check_shard_shapes_and_argument_bytes(ref, arch, cell):
    """Local shapes of rank 0 == ``NamedSharding.shard_shape``; the dry
    run's argument bytes == the sum of the reference's shard bytes (the
    parameters in bf16, AdamW's moments in f32 twice over for train).
    XLA's own ``argument_size_in_bytes`` of a train cell, where the child
    reckoned it, is printed beside it: 4 bytes more, the reference's int32
    step counter, which the port keeps as a Python int."""
    from repro_torch.launch import dryrun as DR

    cfg = widened(arch)
    mesh = DR.fake_mesh((2, 4), ("data", "model"))
    want = ref["cells"][cell[0]]
    got = port_leaves(cfg, cell, mesh)
    for part in ("params", "batch", "caches"):
        if part in want:
            assert got[part] == want[part], part
    info = cell_info(arch, cell, (2, 4))
    ref_bytes = nbytes(want["params"]) + nbytes(want["batch"])
    if cell[3] == "train":
        ref_bytes += 2 * nbytes(want["params"], itemsize=4)
    else:
        ref_bytes += nbytes(want["caches"])
    if "xla_argument_bytes" in want:
        print(f"argument bytes: port {info['memory']['argument_bytes']}, "
              f"reference shards {ref_bytes}, XLA {want['xla_argument_bytes']}")
        assert want["xla_argument_bytes"] == ref_bytes + 4
    assert info["memory"]["argument_bytes"] == ref_bytes


def check_lower_cell(ref, arch, cell):
    """FLOPs, bytes and peak above 0; the reference's ``model_flops``;
    collective bytes 0 on one rank and above 0 on eight; per-device FLOPs
    on (2, 4) between the (1, 1) cell's / 8 and the (1, 1) cell's."""
    out = {}
    for ms in ((1, 1), (2, 4)):
        info = cell_info(arch, cell, ms)
        t = info["terms"]
        assert t["flops_per_dev"] > 0 and t["bytes_per_dev"] > 0
        assert info["memory"]["peak_bytes"] > 0 and info["peak_est"] > 0
        assert info["model_flops_global"] == ref["cells"][cell[0]]["model_flops"]
        assert info["n_chips"] == ms[0] * ms[1]
        out[ms] = t
    assert out[(1, 1)]["collective_bytes_per_dev"] == 0
    assert out[(2, 4)]["collective_bytes_per_dev"] > 0
    one = out[(1, 1)]["flops_per_dev"]
    assert one / 8 <= out[(2, 4)]["flops_per_dev"] <= one


__all__ = ["reference", "widened", "shape_of", "port_leaves", "nbytes", "TRAIN",
           "DECODE", "check_shard_shapes_and_argument_bytes", "check_lower_cell"]
