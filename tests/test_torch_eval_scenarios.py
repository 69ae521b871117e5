"""The port's scenario grid (``repro_torch.eval.scenarios``,
``generalization_grid``) builds the JAX package's graphs, on the CPU.

Every ``build()`` of the smoke uniform grid, the smoke heterogeneous grid
and the smoke generalization grid equals the reference's graph for graph —
parents equal, ``flops``/``param_bytes``/``out_bytes`` bit-equal — and every
``resolve_system`` equals the reference's field by field, ``mem_capacity``
included; the full lists name the same cells (the full grid's ingest cell
too), ``traffic_pool`` and ``hash_seed`` agree, and an ingest scenario's
``build()`` raises ``NotImplementedError`` (ingest is not ported).
"""

import dataclasses

import numpy as np
import pytest

import repro.eval as jeval
import repro_torch.eval as teval

PAIRS = [(t, j) for tg, jg in ((teval.scenario_grid(smoke=True), jeval.scenario_grid(smoke=True)),
                               (teval.hetero_grid(smoke=True), jeval.hetero_grid(smoke=True)),
                               (teval.generalization_grid(smoke=True),
                                jeval.generalization_grid(smoke=True)))
         for t, j in zip(tg, jg, strict=True)]


def same_graphs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert [list(p) for p in g.parents] == [list(p) for p in w.parents], i
        for f in ("flops", "param_bytes", "out_bytes"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), (i, f)
        assert g.model_name == w.model_name and list(g.names) == list(w.names), i


def fields(sc) -> dict:
    """A scenario's fields with its system as a plain dict."""
    out = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    if out.get("system") is not None:
        out["system"] = dataclasses.asdict(out["system"])
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=[t.name for t, _ in PAIRS])
def test_scenario_builds_the_reference_graphs(pair):
    t, j = pair
    assert fields(t) == fields(j)
    gt, gj = t.build(), j.build()
    same_graphs(gt, gj)
    if hasattr(t, "resolve_system"):
        assert dataclasses.asdict(t.resolve_system(gt)) == dataclasses.asdict(
            j.resolve_system(gj))


def test_full_lists_name_the_same_cells():
    for tg, jg in ((teval.scenario_grid(), jeval.scenario_grid()),
                   (teval.hetero_grid(), jeval.hetero_grid()),
                   (teval.generalization_grid(), jeval.generalization_grid())):
        assert [fields(s) for s in tg] == [fields(s) for s in jg]
    assert "ingest/k4" in [s.name for s in teval.scenario_grid()]
    assert [fields(s) for s in teval.ingest_scenarios(smoke=True)] == [
        fields(s) for s in jeval.ingest_scenarios(smoke=True)]
    assert (teval.INGEST_ARCHS, teval.SYNTH_FAMILIES, teval.HETERO_FAMILIES) == (
        jeval.INGEST_ARCHS, jeval.SYNTH_FAMILIES, jeval.HETERO_FAMILIES)


def test_ingest_scenario_is_not_ported():
    sc = teval.ingest_scenarios()[0]
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        sc.build()


@pytest.mark.parametrize("smoke", [True, False])
def test_traffic_pool_matches_reference(smoke):
    pt, nt, mt = teval.traffic_pool(smoke, np.random.default_rng(7))
    pj, nj, mj = jeval.traffic_pool(smoke, np.random.default_rng(7))
    assert (nt, mt) == (nj, mj)
    same_graphs(pt, pj)


def test_seeds_systems_and_families_match_reference():
    from repro.eval.scenarios import hash_seed as jhash
    from repro_torch.eval.scenarios import hash_seed as thash
    for fam in ("chain", "hetero-sys", "gen/layered", "memcap-uniform"):
        for k in (2, 4, 8):
            assert thash(fam, k) == jhash(fam, k)
            assert dataclasses.asdict(teval.hetero_system(k, thash(fam, k))) == \
                dataclasses.asdict(jeval.hetero_system(k, jhash(fam, k)))
    for fam in teval.SYNTH_FAMILIES:
        same_graphs([teval.synthetic_dag(fam, np.random.default_rng(3), 17)],
                    [jeval.synthetic_dag(fam, np.random.default_rng(3), 17)])
    with pytest.raises(ValueError):
        teval.synthetic_dag("ring", np.random.default_rng(0), 8)
    with pytest.raises(ValueError, match="training range"):
        teval.generalization_grid(sizes=(40, 100))
