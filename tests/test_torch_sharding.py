"""The port's sharding rules against the reference's, with no ranks: meshes
described by their shape alone (``jax.sharding.AbstractMesh`` for the
reference, ``repro_torch.launch.mesh.AbstractMesh`` for the port), 16x16,
2x16x16, 2x4 and 2x2x2, and the three layouts, for all ten archs. Every
compared object is equal: ``param_rules``, the ``ParamSpec`` tree (paths,
shapes, dtypes and logical axes, leaf by leaf), ``partition_specs``,
``state_shardings`` of each family's abstract decode state, and
``batch_shardings`` of each cell's ``input_specs``; ``make_dist``'s
properties too. An unknown logical axis raises ``KeyError`` in both."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES, cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import get_shape  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
LAYOUTS = ("tp", "fsdp", "serve")


def _jax_mesh(name):
    sizes, axes = MESHES[name]
    try:
        return jax.sharding.AbstractMesh(sizes, axes)
    except TypeError:  # older jax: AbstractMesh takes ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(zip(axes, sizes)))


def _port_mesh(name):
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _models(arch, layout):
    jcfg = dataclasses.replace(jax_get_config(arch), layout=layout)
    return JaxModel(jcfg), Model(ModelConfig(**dataclasses.asdict(jcfg)), "cpu")


def _entry(e):
    """A partition entry as ``PartitionSpec`` holds it: a one-axis tuple is
    that axis."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec(p):
    """A partition spec (the reference's ``PartitionSpec`` or the port's
    tuple) as a tuple of entries."""
    return tuple(_entry(e) for e in p)


def _duplicate(spec) -> bool:
    """Whether a spec names a mesh axis twice (the reference refuses it)."""
    axes = [a for e in spec for a in ((e,) if isinstance(e, str) else (e or ()))]
    return len(axes) != len(set(axes))


def _path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


CASES = [(a, m, lay) for a in ARCH_IDS for m in MESHES for lay in LAYOUTS]


@pytest.mark.parametrize("arch,mesh,layout", CASES)
def test_rules_specs_and_shardings_equal_the_reference(arch, mesh, layout):
    jm, tm = _models(arch, layout)
    jmesh, tmesh = _jax_mesh(mesh), _port_mesh(mesh)
    rules = jsh.param_rules(jm.cfg, jmesh)
    assert tsh.param_rules(tm.cfg, tmesh) == rules

    # The ParamSpec tree, leaf by leaf with its path.
    jleaves = jax.tree_util.tree_flatten_with_path(
        jm.param_specs(), is_leaf=lambda x: isinstance(x, jparams.ParamSpec))[0]
    tleaves = list(tparams._leaves(tm.param_specs()))
    assert [_path(p) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, js), (_, ts) in zip(jleaves, tleaves):
        assert tuple(js.shape) == tuple(ts.shape) and tuple(js.axes) == tuple(ts.axes)
        assert jnp.dtype(js.dtype).name == str(ts.dtype).removeprefix("torch.")

    # partition_specs and param_shardings.
    jparts = jax.tree.leaves(jparams.partition_specs(jm.param_specs(), rules),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tparts = [tparams.partition_specs(s, rules) for _, s in tleaves]
    assert [_spec(p) for p in jparts] == [_spec(p) for p in tparts]
    from repro_torch import tree as tree_lib

    assert [s.spec for s in tree_lib.leaves(tsh.param_shardings(tm, tmesh))] == tparts

    # The decode state's shardings of the family.
    jstate = jm.init_state(8, 64, abstract=True)
    tstate = tm.init_state(8, 64, abstract=True)
    ts = [_spec(s.spec) for s in tree_lib.leaves(tsh.state_shardings(tm, tmesh, tstate))]
    try:
        js = [_spec(s.spec) for s in jax.tree.leaves(jsh.state_shardings(jm, jmesh, jstate))]
    except Exception as e:  # the fsdp batch entry names the model axis, so does the state's
        assert type(e).__name__ == "DuplicateSpecError" and layout == "fsdp"
        assert any(_duplicate(spec) for spec in ts)
    else:
        assert js == ts

    # batch_shardings of every cell's inputs.
    for name in cells(arch):
        jb = jsh.batch_shardings(jm, jmesh, jm.input_specs(SHAPES[name]))
        tb = tsh.batch_shardings(tm, tmesh, tm.input_specs(get_shape(name)))
        assert set(jb) == set(tb)
        assert {k: _spec(v.spec) for k, v in jb.items()} == {k: _spec(v.spec) for k, v in tb.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_dist_properties_equal_the_reference(mesh, layout):
    jd = jsh.make_dist(_jax_mesh(mesh), layout)
    td = tsh.make_dist(_port_mesh(mesh), layout)
    for prop in ("batch_axes", "model_axis", "batch", "tensor_parallel", "loss_batch", "model_size",
                 "batch_size"):
        assert getattr(td, prop) == getattr(jd, prop), prop


@pytest.mark.parametrize("decode_shape", ["decode_32k", "long_500k"])
def test_state_shardings_at_the_cells_shapes(decode_shape):
    """The decode cells' own state shapes (kv-head or sequence split)."""
    from repro_torch import tree as tree_lib

    for arch in ARCH_IDS:
        if decode_shape not in cells(arch):
            continue
        jm, tm = _models(arch, "tp")
        shape = SHAPES[decode_shape]
        for mesh in ("16x16", "2x16x16"):
            jst = jm.init_state(shape.global_batch, shape.seq_len, abstract=True)
            tst = tm.init_state(shape.global_batch, shape.seq_len, abstract=True)
            js = [_spec(s.spec) for s in jax.tree.leaves(jsh.state_shardings(jm, _jax_mesh(mesh), jst))]
            ts = [_spec(s.spec) for s in tree_lib.leaves(tsh.state_shardings(tm, _port_mesh(mesh), tst))]
            assert js == ts, (arch, mesh)


def test_unknown_logical_axis_raises_keyerror():
    rules = tsh.param_rules(_models("qwen3-1.7b", "tp")[1].cfg, _port_mesh("2x4"))
    bad = {"w": tparams.ParamSpec((4, 4), ("embed", "bogus"), tparams.zeros_init)}
    with pytest.raises(KeyError, match="bogus"):
        tparams.partition_specs(bad, rules)
    jbad = {"w": jparams.ParamSpec((4, 4), ("embed", "bogus"), jparams.zeros_init)}
    with pytest.raises(KeyError, match="bogus"):
        jparams.partition_specs(jbad, rules)


def test_quantized_param_shardings_follow_the_weights():
    """A quantized leaf's ``q`` takes the weight's sharding and its ``s`` the
    same less its last dim, as in the reference."""
    from repro.launch.sharding import quantized_param_shardings as jq

    jm, tm = _models("qwen3-1.7b", "serve")
    jsh_tree, _ = jq(jm, _jax_mesh("2x4"), jm.abstract_params())
    tsh_tree, _ = tsh.quantized_param_shardings(tm, _port_mesh("2x4"), tm.abstract_params())
    from repro_torch import tree as tree_lib

    jl = [_spec(s.spec) for s in jax.tree.leaves(jsh_tree)]
    tl = [_spec(s.spec) for s in tree_lib.leaves(tsh_tree)]
    assert jl == tl
