"""The port's sharding rules against the JAX package's: for every arch of
the registry, full size and ``reduced``, on the meshes (data, model) =
(1, 1), (2, 2), (4, 1), (1, 4) and (pod, data, model) = (2, 2, 2), the
specs of the parameters (``param_pspecs``, with and without FSDP), of
the batches (``batch_pspecs``: train, prefill and decode shapes), of the
caches (``cache_pspecs``, short and long context, with the KV-seq over
``model`` fallback that reduced Mistral's two KV heads meet on (1, 4))
and ``models.common.partition_specs``.

The reference's spec functions read only ``mesh.shape``, so they take a
``jax.sharding.AbstractMesh`` (no devices); the port's take the mapping
of axis sizes (``launch.mesh.mesh_shape`` passes one through).  A spec
is compared as a tuple: the port's spec is the reference's
``PartitionSpec`` as a plain tuple, exactly.
"""
import dataclasses
from types import SimpleNamespace

import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES, SHAPES, get_config, reduced
from repro.distributed import sharding as rsh
from repro.models import build_model as rbuild
from repro.models import common as rcm
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import common as tcm
from repro_torch.models import registry as treg

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
CASES = [(a, m, r) for a in ARCH_NAMES for m in MESHES for r in (False, True)]
IDS = [f"{a}-{m}-{'reduced' if r else 'full'}" for a, m, r in CASES]


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _cfgs(arch, red):
    if red:
        return reduced(get_config(arch)), tconfigs.reduced(tconfigs.get_config(arch))
    return get_config(arch), tconfigs.get_config(arch)


def _same(ref_tree, port_tree):
    ref = {n: tuple(s) for n, s in tcm.iter_leaves(ref_tree)}
    port = dict(tcm.iter_leaves(port_tree))
    assert sorted(ref) == sorted(port)
    for name, spec in ref.items():
        assert port[name] == spec, (name, port[name], spec)


@pytest.mark.parametrize("arch,mesh,red", CASES, ids=IDS)
def test_param_specs_and_partition_specs_equal_the_reference(arch, mesh, red):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = _cfgs(arch, red)
    rabs, tabs = rbuild(rcfg).abstract_params(), treg.params_abstract(tcfg)
    for fsdp in (True, False):
        _same(rsh.param_pspecs(rabs, rmesh, fsdp), tsh.param_pspecs(tabs, tmesh, fsdp))
        assert tsh.param_rules(tmesh, fsdp) == rsh.param_rules(rmesh, fsdp)
        rules = rsh.param_rules(rmesh, fsdp)
        _same(rcm.partition_specs(rabs, rules), tcm.partition_specs(tabs, rules))


@pytest.mark.parametrize("arch,mesh,red", CASES, ids=IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh, red):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = _cfgs(arch, red)
    rmodel = rbuild(rcfg)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape = dataclasses.replace(SHAPES[name], seq_len=64)
        tshape = dataclasses.replace(tconfigs.SHAPES[name], seq_len=64)
        _same(rsh.batch_pspecs(rmodel.batch_spec(shape), rmesh),
              tsh.batch_pspecs(treg.batch_spec(tcfg, tshape), tmesh))
    for b, length in ((1, 64), (2, 48), (8, 64)):
        rc, tc = rmodel.cache_abstract(b, length), treg.cache_abstract(tcfg, b, length)
        for long_context in (False, True):
            _same(rsh.cache_pspecs(rcfg, rc, rmesh, long_context),
                  tsh.cache_pspecs(tcfg, tc, tmesh, long_context))
    rules = {k: v for k, v in rsh.activation_rules(rmesh).items() if k != "mesh"}
    assert {k: v for k, v in tsh.activation_rules(tmesh).items() if k != "mesh"} == rules
    assert tsh.data_axes(tmesh) == rsh.data_axes(rmesh)


def test_reduced_mistral_on_1x4_puts_the_kv_seq_over_model():
    """Two KV heads cannot take a model axis of 4: the caches' seq dim
    does, in both packages."""
    rmesh, tmesh = _meshes("1x4")
    rcfg, tcfg = _cfgs("mistral-nemo-12b", True)
    assert tcfg.num_kv_heads == 2
    spec = dict(tcm.iter_leaves(tsh.cache_pspecs(tcfg, treg.cache_abstract(tcfg, 2, 64), tmesh)))
    assert spec["layers.k"] == (None, "data", "model", None, None)  # [L, B, S, KV, hd]
    ref = dict(tcm.iter_leaves(rsh.cache_pspecs(rcfg, rbuild(rcfg).cache_abstract(2, 64), rmesh)))
    assert tuple(ref["layers.k"]) == spec["layers.k"]


def test_mesh_shape_reads_a_mapping_and_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    assert mesh_shape({"data": 2, "model": 4}) == {"data": 2, "model": 4}
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements((), mesh) == (Replicate(),) * 3
    assert tsh.placements(("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert tsh.placements((("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements((("data", "pod"),), mesh)


def test_constrain_and_gather_are_no_ops_without_rules():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert tsh.current_rules() is None
    assert tsh.constrain(x, ("batch", "vocab")) is x
    tree = {"w": x}
    assert tsh.gather_fsdp(tree) is tree and tsh.gather_fsdp(x) is x
    with tsh.use_activation_rules({"mesh": None, "batch": "data"}):
        assert tsh.constrain(x, ("batch", None)) is x  # a plain tensor is left as it is
    assert tsh.current_rules() is None
