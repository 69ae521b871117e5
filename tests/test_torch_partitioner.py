"""The port's pod-scale partitioner (``repro_torch.core.partitioner``)
against the reference's, the twin of ``tests/test_partitioner.py``.

* ``PodSystem`` and ``EDGETPU``: every field equal;
* ``model_graph`` of the ten full configs at ``train_4k`` and mesh slice
  64: flops, parameter bytes, output bytes (float64 arrays, equal bit for
  bit: the same formulas), parents and names equal;
* ``exact``, ``compiler`` and ``list`` at 8 stages: assignments equal and
  every ``ScheduleEval`` field equal (the same float64 cost model);
* ``respect`` with the release ``checkpoints/respect-v1`` on the CPU (its
  plain decode): the assignments of ``tests/golden/torch_partitions.json``
  (written by ``scripts/make_partition_golden.py`` from the reference), as
  are the file's ``compiler`` and ``exact`` ones, bottlenecks within 1e-12
  relative;
* ``stage_assignment_to_layers`` equal; and the reference test's checks
  (a chain of n_layers + 2 nodes, valid monotone partitions that cover every
  layer, exact no worse than compiler on kimi-k2, zamba2's shared
  attention's bytes counted once).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.core import EDGETPU as JAX_EDGETPU
from repro.core import PodSystem as JaxPodSystem
from repro.core import partitioner as jax_partitioner
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import EDGETPU, PodSystem, RespectScheduler, validate_monotone
from repro_torch.core.partitioner import (model_graph, partition_model,
                                          stage_assignment_to_layers)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_partitions.json").read_text())
STAGES, SLICE = GOLDEN["meta"]["n_stages"], GOLDEN["meta"]["mesh_slice"]
SHAPE = GOLDEN["meta"]["shape"]


def test_systems_equal_the_reference():
    for n in (1, 4, 8):
        assert dataclasses.asdict(PodSystem(n)) == dataclasses.asdict(JaxPodSystem(n))
    assert dataclasses.asdict(EDGETPU) == dataclasses.asdict(JAX_EDGETPU)
    assert PodSystem(8).is_uniform


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_graph_equals_the_reference(arch):
    g = model_graph(get_config(arch), SHAPES[SHAPE], SLICE)
    jg = jax_partitioner.model_graph(jax_get_config(arch), JAX_SHAPES[SHAPE], SLICE)
    for field in ("flops", "param_bytes", "out_bytes"):
        assert np.array_equal(getattr(g, field), getattr(jg, field)), field
    assert [list(p) for p in g.parents] == [list(p) for p in jg.parents]
    assert g.names == jg.names and g.model_name == jg.model_name
    assert g.n == GOLDEN["archs"][arch]["n_nodes"]


@pytest.mark.parametrize("method", ["exact", "compiler", "list"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_host_methods_equal_the_reference(arch, method):
    assign, ev, g = partition_model(get_config(arch), SHAPES[SHAPE], STAGES, method=method,
                                    mesh_slice=SLICE)
    jassign, jev, _ = jax_partitioner.partition_model(jax_get_config(arch), JAX_SHAPES[SHAPE],
                                                      STAGES, method=method, mesh_slice=SLICE)
    assert np.array_equal(assign, np.asarray(jassign))
    for field in dataclasses.fields(jev):
        want, got = getattr(jev, field.name), getattr(ev, field.name)
        assert (got is None and want is None) or np.array_equal(got, want), field.name
    assert stage_assignment_to_layers(get_config(arch), assign) == \
        jax_partitioner.stage_assignment_to_layers(jax_get_config(arch), jassign)
    if method in GOLDEN["archs"][arch]:
        assert list(assign) == GOLDEN["archs"][arch][method]["assignment"]


@pytest.fixture(scope="module")
def release():
    return RespectScheduler.from_release(device="cpu")


def test_respect_partitions_equal_the_golden_file(release):
    assert release.release["params_sha256"] == GOLDEN["meta"]["release_params_sha256"]
    for arch in ARCH_IDS:
        want = GOLDEN["archs"][arch]["respect"]
        assign, ev, g = partition_model(get_config(arch), SHAPES[SHAPE], STAGES,
                                        method="respect", scheduler=release, mesh_slice=SLICE)
        assert list(assign) == want["assignment"], arch
        assert ev.bottleneck_s == pytest.approx(want["bottleneck_s"], rel=1e-12), arch
        assert validate_monotone(g, assign, STAGES), arch
    with pytest.raises(ValueError, match="RespectScheduler"):
        partition_model(get_config("qwen3-14b"), SHAPES[SHAPE], STAGES, method="respect")


def test_model_graph_structure():
    cfg = get_config("qwen3-32b")
    g = model_graph(cfg, SHAPES["train_4k"])
    assert g.n == cfg.n_layers + 2 and g.max_in_degree == 1
    assert g.param_bytes.sum() > 60e9


@pytest.mark.parametrize("arch", ["qwen3-32b", "kimi-k2-1t-a32b", "zamba2-7b"])
def test_partitions_are_valid_and_cover_every_layer(arch):
    cfg = get_config(arch)
    for method in ("exact", "compiler", "list"):
        assign, _, g = partition_model(cfg, SHAPES["train_4k"], 8, method=method, mesh_slice=32)
        assert validate_monotone(g, assign, 8)
        covered = sorted(b for s in stage_assignment_to_layers(cfg, assign) for b in s)
        assert covered == list(range(cfg.n_layers))


def test_exact_no_worse_than_compiler_on_moe_and_shared_params_once():
    cfg = get_config("kimi-k2-1t-a32b")
    _, ev_exact, _ = partition_model(cfg, SHAPES["train_4k"], 8, method="exact", mesh_slice=64)
    _, ev_comp, _ = partition_model(cfg, SHAPES["train_4k"], 8, method="compiler",
                                    mesh_slice=64)
    assert ev_exact.bottleneck_s <= ev_comp.bottleneck_s * (1 + 1e-9)
    g = model_graph(get_config("zamba2-7b"), SHAPES["train_4k"])
    a_nodes = [i for i, nm in enumerate(g.names) if nm.startswith("A")]
    assert len(a_nodes) >= 12 and sum(g.param_bytes[i] > 0 for i in a_nodes) == 1
