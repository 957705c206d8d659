"""The logical-axis sharding tables of the port (``models/params.py``)
against the JAX package's, in pure Python: no process group, no device.

For every registry config, smoke and full, both strategies ("tp" and
"fsdp") and the meshes (1, 1), (2, 4), (4, 2), (1, 8), (16, 16) and
(2, 16, 16), the port's ``AxisRules`` over a ``{name: size}`` mapping and
the reference's over a ``jax.sharding.AbstractMesh`` resolve every
parameter, cache and batch leaf to the same partition spec, record the
same ``notes``, and give the same ``zero1_pspec``; each spec's DTensor
placements map back to it.  The configs take ``tp_pad`` from the mesh as
both packages' step builders do (``_with_tp_pad``).
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.launch import specs as jspecs
from repro.models import params as jparams
from repro.parallel import steps as jsteps
from repro_torch.configs import registry as preg
from repro_torch.configs.base import ShapeConfig as PShape
from repro_torch.launch import specs as pspecs
from repro_torch.models import params as pparams
from repro_torch.parallel import steps as psteps

MESHES = [
    ((1, 1), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((4, 2), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
]
ARCHS = [(a, smoke) for a in sorted(jreg.ARCHS) for smoke in (True, False)]
TRAIN = ("train_4096", 4096, 256, "train")
DECODE = ("serve_1024", 1024, 64, "decode")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _spec_trees(arch, smoke, mesh_shape):
    """``{what: (reference leaves, port leaves)}`` for the params, the
    decode cache and both batches, at the mesh's ``tp_pad``."""
    tp = dict(mesh_shape).get("model", 1)
    cj, cp = jreg.get(arch, smoke), preg.get(arch, smoke)
    if tp > 1 and cj.n_heads:
        cj, cp = dataclasses.replace(cj, tp_pad=tp), dataclasses.replace(cp, tp_pad=tp)
    out = {"params": (jsteps.model_specs(cj), psteps.model_specs(cp))}
    out["cache"] = (
        jspecs.cache_spec_tree(cj, JShape(*DECODE)),
        pspecs.cache_spec_tree(cp, PShape(*DECODE)),
    )
    for shape in (TRAIN, DECODE):
        bj, bp = jspecs.batch_specs(cj, JShape(*shape)), pspecs.batch_specs(cp, PShape(*shape))
        aj, ap = jspecs.batch_pspec_axes(cj, JShape(*shape)), pspecs.batch_pspec_axes(cp, PShape(*shape))
        out[f"batch_{shape[3]}"] = (
            {k: jparams.ParamSpec(bj[k].shape, jnp.float32, aj[k]) for k in bj},
            {k: pparams.ParamSpec(bp[k].shape, torch.float32, ap[k]) for k in bp},
        )
    return out


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_partition_specs_match_the_reference(arch, smoke, strategy):
    for shape, names in MESHES:
        rj = jparams.default_rules(AbstractMesh(shape, names), strategy)
        rp = pparams.default_rules(dict(zip(names, shape)), strategy)
        for what, (tj, tp) in _spec_trees(arch, smoke, zip(names, shape)).items():
            lj, lp = _leaves(tj), _leaves(tp)
            assert [p for p, _ in lj] == [p for p, _ in lp], what
            for (path, sj), (_, sp) in zip(lj, lp):
                assert tuple(sp.shape) == tuple(sj.shape), (what, path)
                assert tuple(sp.axes) == tuple(sj.axes or ()), (what, path)
                got, want = rp.partition_spec(sp), rj.partition_spec(sj)
                assert tuple(got) == tuple(want), (shape, what, path, got, want)
                z_got, z_want = pparams.zero1_pspec(rp, sp), jparams.zero1_pspec(rj, sj)
                assert tuple(z_got) == tuple(z_want), (shape, what, path, z_got, z_want)
                for ps in (got, z_got):
                    pl = pparams.placements(ps, rp.mesh)
                    assert tuple(pparams.pspec_of(pl, rp.mesh, len(sp.shape))) == tuple(ps)
        assert rp.notes == rj.notes, shape


def test_zero1_adds_data_axis():
    """The reference's ``test_model_parts.py::test_zero1_adds_data_axis``
    (:122): at data = 1 nothing changes; and at (2, 4) 'data' lands on
    the first free dimension it divides, in both packages."""
    for shape, want in (((1, 1), (None, "model")), ((2, 4), ("data", "model"))):
        rj = jparams.default_rules(AbstractMesh(shape, ("data", "model")))
        rp = pparams.default_rules({"data": shape[0], "model": shape[1]})
        sj = jparams.ParamSpec((4, 8), jnp.float32, (None, "mlp"))
        sp = pparams.ParamSpec((4, 8), torch.float32, (None, "mlp"))
        got = pparams.zero1_pspec(rp, sp)
        assert tuple(got) == tuple(jparams.zero1_pspec(rj, sj)) == want
        assert len(got) <= 2
    # no free divisible dimension: the parameter's own spec
    rp = pparams.default_rules({"data": 2, "model": 4})
    assert tuple(pparams.zero1_pspec(rp, pparams.ParamSpec((3, 8), torch.float32, (None, "mlp")))) == (None, "model")


def test_placements_refuse_a_minor_first_rule():
    """A rule that lists its mesh axes out of the mesh's order would make
    DTensor shard the dimension minor-first: ``placements`` raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"data": 2, "model": 4}
    assert pparams.placements(pparams.PartitionSpec(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert pparams.placements(pparams.PartitionSpec(None, "model"), mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        pparams.placements(pparams.PartitionSpec(("model", "data"), None), mesh)
    rules = pparams.AxisRules(rules={"embed": ("model", "data")}, mesh=mesh)
    with pytest.raises(ValueError, match="order"):
        rules.placements(pparams.ParamSpec((8, 8), torch.float32, ("embed", None)))


def test_param_spec_axes_are_validated():
    with pytest.raises(ValueError, match="axes"):
        pparams.ParamSpec((4, 8), torch.float32, ("embed",))
    with pytest.raises(ValueError, match="axes"):
        jparams.ParamSpec((4, 8), jnp.float32, ("embed",))
