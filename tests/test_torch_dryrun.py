"""The port's sharded dry run against the reference's, on the CPU.

- ``param_specs`` (in the reference's layout through ``reference_path``)
  and ``stacked_cache_specs`` equal the reference's, leaf for leaf, for
  all ten archs; ``pick_rules`` equals the reference's for every shape on
  the (16, 16) and (2, 16, 16) production meshes.
- On a (2, 4) fake mesh, for the widened yi-6b smoke config of
  ``tests/test_dryrun_small.py``: every leaf's rank-0 local shape equals
  the reference's ``NamedSharding.shard_shape`` (parameters, batch, decode
  caches), and the dry run's argument bytes equal the sum of those shard
  shapes times their dtypes' sizes (exact).
- ``lower_cell`` for ``train_tiny`` and ``decode_tiny`` on (1, 1) and
  (2, 4): FLOPs, bytes and peak above 0, ``model_flops_global`` equal to
  the reference's, collective bytes 0 on one rank and above 0 on eight,
  and the per-device FLOPs on (2, 4) between the (1, 1) cell's / 8 and the
  (1, 1) cell's.
- ``lower_graphmp`` on a small workload on 8 fake ranks: per-device ELL
  bytes equal ``device_graph_specs``' stand-ins' share, and the all-gather
  bytes the padded message array.

Jamba's cells are in ``tests/test_torch_dryrun_hybrid.py``.  The
reference side runs in a child process (``tests/_dryrun_parity.py``).
"""

import pytest

from _dryrun_parity import (DECODE, TRAIN, check_lower_cell,
                            check_shard_shapes_and_argument_bytes, reference)
from repro import configs as ref_configs
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.launch import dryrun as DR
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.params import reference_path

ARCH = "yi-6b"


@pytest.fixture(scope="module")
def ref():
    return reference(ARCH, want_xla=True)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_and_cache_specs_equal_the_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    want = dict(_leaves(RM.param_specs(rcfg)))
    got = {}
    for name, spec in M.param_specs(cfg).items():
        path, g = reference_path(name, cfg)
        got.setdefault(path, set()).add(spec if g is None else ("layers",) + spec)
    assert set(got) == set(want)
    for path, specs in got.items():
        assert specs == {want[path]}, path
    assert T.stacked_group_specs(cfg) == RT.stacked_group_specs(rcfg)
    assert T.stacked_cache_specs(cfg) == RT.stacked_cache_specs(rcfg)


def test_pick_rules_equal_the_reference(ref):
    class Stand:  # the port's view of a DeviceMesh
        def __init__(self, shape, axes):
            self.mesh_dim_names, self.shape = axes, shape

    for multi in (False, True):
        shp, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else (
            (16, 16), ("data", "model"))
        for sname, shape in SHAPES.items():
            got = DR.pick_rules(Stand(shp, axes), shape)
            want = ref["rules"][f"{multi}/{sname}"]
            norm = lambda r: {k: list(v) if isinstance(v, tuple) else v
                              for k, v in r.items()}
            assert norm(got) == norm(want), (multi, sname)


@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c[0])
def test_shard_shapes_and_argument_bytes_equal_the_reference(ref, cell):
    check_shard_shapes_and_argument_bytes(ref, ARCH, cell)


@pytest.mark.parametrize("cell", [TRAIN, DECODE], ids=lambda c: c[0])
def test_lower_cell_terms(ref, cell):
    check_lower_cell(ref, ARCH, cell)


def test_lower_graphmp_on_a_small_workload(monkeypatch):
    from repro_torch.configs import graphmp as G
    from repro_torch.core.distributed import device_graph_specs

    monkeypatch.setitem(G.WORKLOADS, "tiny",
                        G.GraphWorkload("tiny", 10_000, 200_000))
    mesh = DR.fake_mesh((2, 4), ("data", "model"))
    info = DR.lower_graphmp(mesh, "tiny", verbose=False)
    specs = device_graph_specs(10_000, 200_000, 8)
    share = sum(t.numel() * t.element_size() for t in specs.values()) // 8
    assert info["memory"]["argument_bytes"] == share
    col = info["collectives"]
    assert col["bytes_by_kind"]["all-gather"] == specs["src_vals"].numel() * 4
    assert col["count_by_kind"]["all-gather"] == 1
    assert info["terms"]["flops_per_dev"] > 0 and info["n_chips"] == 8
