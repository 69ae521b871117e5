"""The logical-axis sharding layer of the port held to the reference's.

For the ten archs at their full configs, under both settings of each layout
flag: ``Model.param_axes`` and ``cache_axes`` equal ``repro``'s tree for
tree, and every leaf resolves to the reference's ``resolve_axes`` spec on
the (16, 16), (2, 16, 16), (4, 8, 4), (2, 4) and (1, 1) meshes (the
reference's on ``jax.sharding.AbstractMesh`` with shapes from
``jax.eval_shape``; the port's on its own abstract mesh with shapes from
the ``meta`` device).  ``input_records`` against the reference's
``input_specs`` for every applicable ``SHAPES`` cell; a ``LogicalRules``
override, the dedup rule and the divisibility fallback; the placements of
a resolved spec on a one-rank ``DeviceMesh``.
"""

from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import SHAPES as JAX_SHAPES
from repro.models import flags as jax_flags
from repro.models.model import build_model as jax_build_model
from repro.parallel import sharding as jax_sharding
from repro.models.common import param as jax_param
from repro.models.common import split_annotated as jax_split_annotated
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import named_leaves
from repro_torch.launch.mesh import (make_pipeline_mesh, make_production_mesh,
                                     single_device_mesh, small_test_mesh)
from repro_torch.models import flags
from repro_torch.models.common import Init, param, split_annotated
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import AbstractMesh, PartitionSpec

MESHES = {
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
    "4x8x4": make_pipeline_mesh(4),
    "2x4": small_test_mesh(),
    "1x1": AbstractMesh((1, 1), ("data", "model")),
}
# both settings of each flag (they touch disjoint layouts: the MLP and GQA)
FLAGS = {"default": dict(fused_w13=True, head_sharded_layouts=True),
         "unfused": dict(fused_w13=False, head_sharded_layouts=False)}
CACHE = (2, 64)     # (batch, max_len) beside each arch's decode cells


def _jax_mesh(mesh: AbstractMesh) -> JaxAbstractMesh:
    return JaxAbstractMesh(mesh.axis_sizes, mesh.axis_names)


def _assert_same_specs(axes, port_shapes, jax_shapes, label):
    """Every leaf of ``axes`` resolves alike on every mesh."""
    ax = dict(named_leaves(axes))
    ps = {k: tuple(v.shape) for k, v in named_leaves(port_shapes)}
    js = {k: tuple(v.shape) for k, v in named_leaves(jax_shapes)}
    assert set(ax) == set(ps) == set(js), label
    assert ps == js, label
    for mname, mesh in MESHES.items():
        jm = _jax_mesh(mesh)
        for path, a in ax.items():
            got = sharding.resolve_axes(a, ps[path], mesh)
            want = jax_sharding.resolve_axes(a, js[path], jm)
            assert tuple(got) == tuple(want), f"{label} {mname} {path}: {got} != {want}"


@pytest.fixture(params=list(FLAGS))
def flag_setting(request):
    kw = FLAGS[request.param]
    with flags.flags(**kw), jax_flags.flags(**kw):
        yield request.param


def _cache_cells(cfg):
    cells = [CACHE]
    for shape in SHAPES.values():
        if shape.kind == "decode" and shape_applicable(cfg, shape)[0]:
            cells.append((shape.global_batch, shape.seq_len))
    return cells


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_resolve_like_the_reference(arch, flag_setting):
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    jmodel = jax_build_model(cfg)
    axes = model.param_axes()
    assert axes == jmodel.param_axes(), arch
    _assert_same_specs(axes, model.init_params(),
                       jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)),
                       f"{arch} params {flag_setting}")
    caxes = model.cache_axes()
    assert caxes == jmodel.cache_axes(), arch
    for b, m in _cache_cells(cfg):
        _assert_same_specs(caxes, model.init_cache(b, m),
                           jax.eval_shape(lambda: jmodel.init_cache(b, m)),
                           f"{arch} cache {b}x{m} {flag_setting}")


def test_flags_change_the_layouts():
    cfg = get_config("internlm2-1.8b")       # 16 heads: the 3-D layout applies
    model = build_model(cfg, device="meta")
    attn = model.param_axes()["blocks"]["u0"]["attn"]
    assert attn["wq"] == ("layers", "embed", "heads", None)
    assert set(model.param_axes()["blocks"]["u0"]["mlp"]) == {"w13", "w2"}
    with flags.flags(fused_w13=False, head_sharded_layouts=False):
        attn = model.param_axes()["blocks"]["u0"]["attn"]
        assert attn["wq"] == ("layers", "embed", "heads")
        assert set(model.param_axes()["blocks"]["u0"]["mlp"]) == {"w1", "w3", "w2"}
        p = model.init_params()["blocks"]["u0"]
        assert p["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model, 16 * cfg.resolved_head_dim)
        assert p["mlp"]["w1"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert flags.get("fused_w13") and flags.get("head_sharded_layouts")
    with pytest.raises(KeyError):
        flags.set_flag("no_such_flag", True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_records_match_the_reference(arch):
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    jmodel = jax_build_model(cfg)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        specs, axes = model.input_records(shape)
        jspecs, jaxes = jmodel.input_specs(JAX_SHAPES[name])
        assert axes == jaxes, (arch, name)
        assert list(specs) == list(jspecs), (arch, name)
        for key, rec in specs.items():
            assert tuple(rec.shape) == jspecs[key].shape, (arch, name, key)
            assert str(rec.dtype).split(".")[-1] == str(jspecs[key].dtype), (arch, name, key)
        for mname, mesh in MESHES.items():
            got = sharding.tree_shardings(axes, specs, mesh)
            for key in specs:
                want = jax_sharding.resolve_axes(jaxes[key], jspecs[key].shape, _jax_mesh(mesh))
                assert tuple(got[key].spec) == tuple(want), (arch, name, mname, key)
        meta = model.input_specs(shape)
        assert set(meta) == set(specs) - {"kv_len"}
        assert all(meta[k].is_meta and tuple(meta[k].shape) == specs[k].shape for k in meta)


def test_logical_rules_override_dedup_and_fallback():
    mesh, jmesh = MESHES["16x16"], _jax_mesh(MESHES["16x16"])
    cases = [
        # the mLSTM's (mlp, heads): both map to "model", the first wins
        (("mlp", "heads"), (4096, 4096)),
        # qwen3-14b's 40 heads do not divide 16: replicated
        (("embed", "heads"), (5120, 40)),
        (("batch", "cache_seq", "cache_heads", None), (128, 32768, 8, 128)),
        (("batch", None), (3, 7)),
    ]
    want = [PartitionSpec("model", None), PartitionSpec("data", None),
            PartitionSpec("data", "model", None, None), PartitionSpec(None, None)]
    for (axes, shape), w in zip(cases, want):
        got = sharding.resolve_axes(axes, shape, mesh)
        assert got == w and tuple(got) == tuple(jax_sharding.resolve_axes(axes, shape, jmesh))
    override = {"seq": "model", "heads": None, "batch": ("data", "model")}
    with sharding.LogicalRules(override), jax_sharding.LogicalRules(override):
        for axes, shape in [(("batch", "seq", "heads"), (256, 4096, 32)),
                            (("batch", "seq"), (16, 4096)), (("embed", "heads"), (64, 32))]:
            got = sharding.resolve_axes(axes, shape, mesh)
            assert tuple(got) == tuple(jax_sharding.resolve_axes(axes, shape, jmesh)), axes
        assert sharding.resolve_axes(("batch", "seq"), (256, 4096), mesh) == \
            PartitionSpec(("data", "model"), None)
    assert sharding.resolve_axes(("seq", "heads"), (64, 32), mesh) == PartitionSpec(None, "model")
    # "batch" over ("pod", "data") on a mesh with a pod axis
    got = sharding.resolve_axes(("batch", None), (512, 8), MESHES["2x16x16"])
    assert got == PartitionSpec(("pod", "data"), None)


@pytest.fixture
def cpu_mesh():
    """A one-rank CPU DeviceMesh; the process group it made is torn down
    after the test (other files in this worker expect none)."""
    import torch.distributed as dist
    had_group = dist.is_initialized()
    yield single_device_mesh("cpu")
    if not had_group and dist.is_initialized():
        dist.destroy_process_group()


def test_shardings_on_a_one_rank_device_mesh(cpu_mesh):
    mesh = cpu_mesh
    assert sharding.axis_sizes(mesh) == {"data": 1, "model": 1}
    sh = sharding.sharding_for(("batch", "heads"), (4, 32), mesh)
    assert sh.spec == PartitionSpec("data", "model")
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    assert sh.placements == (Shard(0), Shard(1))
    assert sharding.sharding_for(("mlp", "heads"), (8, 8), mesh).placements == \
        (Replicate(), Shard(0))
    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tensor(x, mesh, sh.placements[:1] + (Replicate(),))
    assert torch.equal(d.full_tensor(), x)
    assert sharding.constrain(x, ("batch", None), mesh) is x
    assert sharding.constrain(x, ("batch", None)) is x
    with pytest.raises(NotImplementedError,
                       match="'data' has size 2 on an abstract mesh, which has no devices"):
        sharding.constrain(x, ("batch", None), MESHES["2x4"])
    with pytest.raises(NotImplementedError, match="'model' has size 4 on an abstract mesh"):
        sharding.constrain(x, (None, None), sharding.AbstractMesh((1, 4), ("data", "model")))
    assert sharding.batch_sharding(mesh).spec == PartitionSpec("data")
    dp = sharding.data_parallel_mesh(device="cpu")
    assert sharding.axis_sizes(dp) == {"data": 1}
    with pytest.raises(ValueError, match="asked for 2 devices"):
        sharding.data_parallel_mesh(2, device="cpu")
    assert sharding.sharding_for(("batch",), (4,), MESHES["2x4"]).placements is None


def test_annotated_params_split_like_the_reference():
    init = Init(torch.device("cpu"), torch.Generator().manual_seed(0))
    tree = {"w": param(init, (8, 4), ("embed", "mlp")),
            "blk": {"b": param(init, (4,), (None,), kind="zeros"),
                    "g": param(init, (4,), ("mlp",), dtype=torch.float32, kind="ones")}}
    jtree = {"w": jax_param(jax.random.PRNGKey(0), (8, 4), ("embed", "mlp")),
             "blk": {"b": jax_param(None, (4,), (None,), init="zeros"),
                     "g": jax_param(None, (4,), ("mlp",), init="ones")}}
    values, axes = split_annotated(tree)
    jvalues, jaxes = jax_split_annotated(jtree)
    assert axes == jaxes
    assert [(k, tuple(v.shape)) for k, v in named_leaves(values)] == \
        [(k, tuple(v.shape)) for k, v in named_leaves(jvalues)]
    assert values["w"].dtype == torch.bfloat16 and float(values["blk"]["g"].sum()) == 4.0
    assert float(values["blk"]["b"].abs().sum()) == 0.0
    # fan-in scaling: N(0, 1) / sqrt(8)
    assert 0.05 < float(values["w"].float().std()) < 0.8
