"""The port's multi-pod dry run (``repro_torch.launch.dryrun``, ``cost``,
``roofline``, ``perfprobe``) held to the reference's (``repro.launch.dryrun``
and ``repro.utils.hlo.analyze_hlo``).

* (a) SMOKE configs of a dense GQA arch, minicpm3-4b's MLA, an MoE arch and
  zamba2-7b x train / prefill / decode, and xlstm-350m's prefill and train
  step, on a (2, 4) mesh: the
  reference lowers them with XLA on 8 host devices (``memory_analysis()``,
  ``analyze_hlo``), the port traces its own step over a fake 8-rank world;
* (b) the golden cells of ``tests/golden/torch_dryrun.json`` (written by
  ``scripts/make_dryrun_golden.py`` from the reference at 256 and 512 host
  devices), and internlm2-1.8b's two train cells traced with ``remat`` held
  to the reference's default lowering (``remat_default``) in that file;
* (c) collectives: none on a 1 x 1 mesh, some in every golden cell where the
  reference has some;
* (d) the roofline's arithmetic on hand-made ``StepCost`` records;
* (e) the CLI with ``jax`` unimportable, read by
  ``benchmarks/roofline_table.py``; the perf probe on one SMOKE cell.

The bounds: argument and output bytes per device equal (the reference's
outputs less XLA's 8-byte tuple entry a leaf), ``model_flops`` equal within
1e-12 relative, per-device flops within 5 % (PERF.md §2); xlstm-350m's train
step within 5 % of XLA's flops plus ``SsdScan.backward``'s recompute, work
the port does and XLA does not, reckoned from the shapes (ROADMAP §C, C11).  One exception is
recorded in ROADMAP §C and checked here as what it is: a prefill's cache
comes back in the decode step's cache layout, where XLA leaves the
reference's prefill outputs unconstrained.  Every dry run runs in a process
of its own (one fake process group a process), three at a time.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests" / "golden" / "torch_dryrun.json").read_text())
GOLDEN_CELLS = sorted(GOLDEN["cells"])
SMALL_ARCHS = ("internlm2-1.8b", "minicpm3-4b", "qwen3-moe-235b-a22b", "zamba2-7b")
SMALL_SHAPES = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 8)}   # (seq, batch)
SMALL_MICROBATCHES = 2
# and the sLSTM's time loop over local shards (xlstm-350m's prefill; its
# decode takes kv_len, which XLA prunes as unused; its train step does a
# recompute the reference does not: XLSTM_TRAIN, held on its own below)
SMALL_CELLS = [f"{a}:{k}" for a in SMALL_ARCHS for k in SMALL_SHAPES] + ["xlstm-350m:prefill"]
XLSTM_TRAIN = "xlstm-350m:train"
# the golden train cells whose reference record holds its default lowering
# (remat on) beside the golden one
REMAT_CELLS = ("internlm2-1.8b__train_4k__single", "internlm2-1.8b__train_4k__multi")
TUPLE_ENTRY = 8     # XLA's CPU memory analysis: one pointer an output leaf
_REF_CHILD = textwrap.dedent(r"""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp
    from repro.configs import ShapeConfig, TrainConfig, get_smoke_config
    from repro.launch import steps
    from repro.launch.mesh import small_test_mesh
    from repro.models.model import analytic_flops, build_model
    from repro.utils.hlo import analyze_hlo
    from repro.utils.jaxcompat import set_mesh
    shapes, m = json.loads(sys.argv[1]), int(sys.argv[2])
    out = {}
    for cell in json.loads(sys.argv[3]):
        arch, kind = cell.split(":")
        seq, b = shapes[kind]
        cfg, shape = get_smoke_config(arch), ShapeConfig(kind, seq, b, kind)
        mesh = small_test_mesh(2, 4)
        model = build_model(cfg, remat=False)
        specs, axes = model.input_specs(shape)
        key = jax.random.PRNGKey(0)
        with set_mesh(mesh):
            p = jax.eval_shape(model.init_params, key)
            if kind == "train":
                tc = TrainConfig(microbatches=m, master_fp32=False, remat=False)
                fn, _, opt = steps.make_train_step(model, mesh, tc, specs, axes, donate=False)
                lowered = fn.lower(p, jax.eval_shape(opt.init, p), specs)
            elif kind == "prefill":
                fn, _ = steps.make_prefill_step(model, mesh, specs, axes)
                lowered = fn.lower(p, specs)
            else:
                fn, _ = steps.make_decode_step(model, mesh, b, seq, donate=False)
                cache = jax.eval_shape(lambda: model.init_cache(b, seq))
                lowered = fn.lower(p, jax.ShapeDtypeStruct((b, 1), jnp.int32), cache,
                                   jax.ShapeDtypeStruct((), jnp.int32))
            comp = lowered.compile()
        mem = comp.memory_analysis()
        cost = analyze_hlo(comp.as_text())
        out[cell] = {"memory": {"argument_bytes": int(mem.argument_size_in_bytes),
                                "output_bytes": int(mem.output_size_in_bytes)},
                     "flops_per_device": cost.flops,
                     "collective_bytes_by_kind": cost.collective_bytes_by_kind,
                     "model_flops": analytic_flops(cfg, shape),
                     "outputs": [None] * len(jax.tree_util.tree_leaves(lowered.out_info))}
    print(json.dumps(out))
""")

_PORT_CHILD = textwrap.dedent(r"""
    import json, sys
    sys.modules["jax"] = None              # any import of jax now raises
    sys.modules["repro"] = None
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.launch.dryrun import lower_cell, trace_step
    from repro_torch.models.model import analytic_flops
    shapes, m, jobs = json.loads(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
    out = {}
    for job in jobs:
        if job.count("__") >= 2:                       # a golden cell, maybe with __remat
            arch, shape, mesh, *remat = job.split("__")
            rec = lower_cell(arch, shape, mesh == "multi", remat=bool(remat))
            out[job] = {"memory": rec["memory"], "cost": rec["cost"],
                        "roofline": rec["roofline"], "outputs": rec["outputs"]}
            continue
        arch, kind, mesh = job.split(":")
        seq, b = shapes[kind]
        cfg, shape = get_smoke_config(arch), ShapeConfig(kind, seq, b, kind)
        dims = (2, 4) if mesh == "2x4" else (1, 1)
        scopes = arch == "xlstm-350m" and kind == "train"
        res = trace_step(cfg, shape, dims, ("data", "model"),
                         microbatches=m if kind == "train" else 1, scopes=scopes)
        c = res["cost"]
        out[job] = {"memory": res["memory"], "flops_per_device": c.flops,
                    "collective_bytes": c.collective_bytes,
                    "collective_bytes_by_kind": c.collective_bytes_by_kind,
                    "model_flops": analytic_flops(cfg, shape), "outputs": res["outputs"]}
        if scopes:
            out[job]["scope_flops"] = {n: f for n, (_, f, _, _) in res["trace"].scopes.items()}
    print(json.dumps(out))
""")


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _start(code: str, jobs: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(SMALL_SHAPES), str(SMALL_MICROBATCHES),
         json.dumps(jobs)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """(reference small cells, port small + 1 x 1 cells, port golden cells),
    computed by three processes at once."""
    trains = [c for c in GOLDEN_CELLS if "__train_" in c]
    procs = [_start(_REF_CHILD, SMALL_CELLS + [XLSTM_TRAIN]),
             _start(_PORT_CHILD, [f"{c}:2x4" for c in SMALL_CELLS]
                    + ["internlm2-1.8b:train:1x1"] + [c for c in GOLDEN_CELLS if c not in trains]),
             _start(_PORT_CHILD, trains + [f"{c}__remat" for c in REMAT_CELLS]
                    + [f"{XLSTM_TRAIN}:2x4"])]
    ref, port, port_train = (_result(p) for p in procs)
    port.update(port_train)
    return ref, port


def _cache_local_bytes(arch: str, kind: str) -> int:
    """The prefill cache's bytes a device of the (2, 4) mesh holds at the
    resolved cache shardings (the decode step's layout)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import cache_shardings, named_leaves
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import AbstractMesh
    seq, b = SMALL_SHAPES[kind]
    mesh = AbstractMesh((2, 4), ("data", "model"))
    model = build_model(get_smoke_config(arch), device="meta")
    shapes = dict(named_leaves(model.init_cache(b, seq)))
    total = 0
    for name, sh in named_leaves(cache_shardings(model, mesh, b, seq)):
        div = 1
        for entry in sh.spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                div *= mesh.shape.get(ax, 1) if ax else 1
        t = shapes[name]
        total += math.prod(t.shape) // div * torch.empty((), dtype=t.dtype).element_size()
    return total


def _problems(port: dict, ref: dict, flops: float, prefill: bool) -> list:
    from repro_torch.launch.dryrun import reference_problems
    return reference_problems(port["memory"], flops, port["model_flops"], ref,
                              port["outputs"] if prefill else None)


# ---------------------------------------------------------------- (a) small mesh
@pytest.mark.parametrize("cell", SMALL_CELLS)
def test_small_mesh_matches_reference(runs, cell):
    ref, port = runs
    arch, kind = cell.split(":")
    p, r = port[f"{cell}:2x4"], ref[cell]
    ratio = p["flops_per_device"] / r["flops_per_device"]
    print(f"{cell}: per-device flops {p['flops_per_device']:.6g} against the reference's "
          f"{r['flops_per_device']:.6g} ({ratio:.4f}x)")
    assert not _problems(p, r, p["flops_per_device"], kind == "prefill")
    if kind == "prefill":   # the cache at the resolved (decode) shardings, the logits alike
        logits = next(o for o in p["outputs"] if o["name"] == "0")
        want = r["memory"]["output_bytes"] - TUPLE_ENTRY * len(r["outputs"])
        assert p["memory"]["output_bytes"] == logits["local_bytes"] + _cache_local_bytes(arch, kind)
        print(f"{cell}: prefill output bytes {p['memory']['output_bytes']} against the "
              f"reference's {want} (its cache in XLA's unconstrained layout)")


def _xlstm_train_recompute() -> float:
    """The per-device flops of ``ref.ssd_chunked`` in the port's
    xlstm-350m SMOKE train step on a (2, 4) mesh, reckoned from the shapes
    (2 microbatches of 2 of each data rank's 4 rows, S = 64; 2 mLSTM layers,
    2 heads on the 4-way ``model`` axis, so that the heads and the scans'
    operands are whole on every rank).  ``SsdScan.backward`` recomputes the
    plain chunked scan under autograd, where the reference's XLA backward
    reads the forward's values: both scans of each layer, C B^T, its product
    with x, C h and the state update over whole (chunk, chunk) blocks."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("xlstm-350m")
    data = 2
    seq, batch = SMALL_SHAPES["train"]
    mb = batch // data // SMALL_MICROBATCHES          # rows a microbatch on each rank
    layers = cfg.pattern().count("x")
    nh = cfg.n_heads
    ph = cfg.ssm.expand * cfg.d_model // nh
    q, nc = cfg.ssm.chunk, seq // cfg.ssm.chunk
    runs = SMALL_MICROBATCHES * layers
    return runs * sum(2.0 * mb * nh * nc * (q * q * ph + q * q * p + 2 * q * ph * p)
                      for p in (ph, 1))               # the numerator and the normalizer


def test_xlstm_train_is_the_reference_plus_its_recompute(runs):
    """C11: the port's xlstm-350m train step on (2, 4) counted 1.41x XLA's
    per-device flops.  Of the excess, the mLSTM's weight gradients computed
    whole on every ``model`` rank were a fault, fixed by pinning ``up`` and
    x_in to their column shards (``models/ssm.mlstm_forward``); what stays
    is ``SsdScan.backward``'s recompute, work the port does and the
    reference does not.  Held to XLA's flops plus the recompute, reckoned
    from the shapes (:func:`_xlstm_train_recompute`), within the 5 % bound
    of every cell; the recompute's traced scope equals its reckoning."""
    ref, port = runs
    p, r = port[f"{XLSTM_TRAIN}:2x4"], ref[XLSTM_TRAIN]
    recompute = _xlstm_train_recompute()
    assert p["scope_flops"]["ref.ssd_chunked"] == pytest.approx(recompute, rel=1e-12)
    want = r["flops_per_device"] + recompute
    ratio = p["flops_per_device"] / want
    print(f"{XLSTM_TRAIN}: per-device flops {p['flops_per_device']:.6g} against the reference's "
          f"{r['flops_per_device']:.6g} + recompute {recompute:.6g} = {want:.6g} ({ratio:.4f}x; "
          f"{p['flops_per_device'] / r['flops_per_device']:.4f}x the reference alone)")
    assert abs(ratio - 1) <= 0.05
    # argument and output bytes and the model flops as every cell's; the
    # port's flops less the recompute against XLA's
    assert not _problems(p, r, p["flops_per_device"] - recompute, False)


# ---------------------------------------------------------------- (b) golden cells
@pytest.mark.parametrize("cell", GOLDEN_CELLS)
def test_golden_cell_matches_reference(runs, cell):
    _, port = runs
    ref = GOLDEN["cells"][cell]
    p = dict(port[cell], model_flops=port[cell]["roofline"]["model_flops"])
    rl = p["roofline"]
    ratio = rl["flops_per_device"] / ref["hlo_cost"]["flops_per_device"]
    print(f"{cell}: per-device flops {rl['flops_per_device']:.6g} against the reference's "
          f"{ref['hlo_cost']['flops_per_device']:.6g} ({ratio:.4f}x)")
    prefill = "__prefill_" in cell
    assert not _problems(p, ref, rl["flops_per_device"], prefill)
    if prefill:      # the logits as the reference lays them out; the cache in the decode layout
        sizes = {"pod": 2, "data": 16, "model": 16}
        want = ref["outputs"][0]
        logits = next(o for o in p["outputs"] if o["name"] == "0")
        assert logits["local_bytes"] == math.prod(want["shape"]) * 2 // math.prod(
            sizes[a] for a in want["spec"] if a)
        print(f"{cell}: prefill output bytes {p['memory']['output_bytes']} against the "
              f"reference's {ref['memory']['output_bytes'] - TUPLE_ENTRY * len(ref['outputs'])}"
              " (its cache in XLA's unconstrained layout)")


@pytest.mark.parametrize("cell", REMAT_CELLS)
def test_remat_cell_matches_reference_default_lowering(runs, cell):
    """``remat=True`` (``build_model``'s default, as the reference's): the
    backward recomputes each unit's forward, which the golden file's
    ``remat_default`` record (the reference's default lowering) counts;
    its per-device flops within the same 5 %, and well above the cell's
    own lowering without remat."""
    _, port = runs
    ref = GOLDEN["cells"][cell]
    got = port[f"{cell}__remat"]["roofline"]["flops_per_device"]
    want = ref["remat_default"]["hlo_cost"]["flops_per_device"]
    plain = port[cell]["roofline"]["flops_per_device"]
    print(f"{cell} remat: per-device flops {got:.6g} against the reference's default lowering "
          f"{want:.6g} ({got / want:.4f}x); without remat {plain:.6g} (reference "
          f"{ref['hlo_cost']['flops_per_device']:.6g})")
    assert port[f"{cell}__remat"]["memory"]["argument_bytes"] == port[cell]["memory"][
        "argument_bytes"]
    assert abs(got / want - 1) <= 0.05
    assert got > 1.2 * plain


# ---------------------------------------------------------------- (c) collectives
def test_no_collectives_on_one_device(runs):
    _, port = runs
    p = port["internlm2-1.8b:train:1x1"]
    assert p["collective_bytes"] == 0 and not p["collective_bytes_by_kind"]
    assert p["flops_per_device"] > 0


@pytest.mark.parametrize("cell", GOLDEN_CELLS)
def test_golden_collectives(runs, cell):
    _, port = runs
    mine = port[cell]["cost"]["collective_bytes_by_kind"]
    theirs = GOLDEN["cells"][cell]["hlo_cost"]["collective_bytes_by_kind"]
    total_mine, total_theirs = sum(mine.values()), sum(theirs.values())
    print(f"{cell}: collective bytes by kind, port {mine}, reference {theirs}; "
          f"ratio {total_mine / total_theirs if total_theirs else float('nan'):.3f}")
    if total_theirs > 0:
        assert total_mine > 0


# ---------------------------------------------------------------- (d) roofline
def _cost(**kw):
    from repro_torch.launch.cost import StepCost
    return StepCost(**kw)


def test_roofline_terms_and_dominant():
    from repro_torch.launch.roofline import HW, roofline_from_cost
    c = _cost(flops=989e12, bytes_accessed=6.7e12, bytes_bf16eq=6.7e12)
    rl = roofline_from_cost(c, chips=4, model_flops=2 * 989e12)
    assert rl.compute_s == pytest.approx(1.0) and rl.memory_s == pytest.approx(2.0)
    assert rl.collective_s == 0.0 and rl.dominant == "memory"
    assert rl.step_time_lower_bound_s == pytest.approx(2.0)
    assert rl.mfu_bound == pytest.approx(2 * 989e12 / (4 * HW["peak_flops"] * 2.0))
    assert rl.model_flops_ratio == pytest.approx(0.5)
    d = rl.as_dict()
    assert d["dominant"] == "memory" and d["step_lower_bound_s"] == pytest.approx(2.0)
    assert d["memory_s_raw"] == d["memory_s"]


def test_ring_factors():
    from repro_torch.launch.roofline import collective_seconds
    c = _cost()
    c.add_collective("all-reduce", "ib", 50e9)
    c.add_collective("all-gather", "ib", 50e9)
    c.add_collective("reduce-scatter", "ib", 50e9)
    c.add_collective("all-to-all", "ib", 50e9)
    c.add_collective("collective-permute", "ib", 50e9)
    assert collective_seconds(c) == pytest.approx(2 + 1 + 1 + 1 + 1)
    assert collective_seconds(c, link_bw=100e9) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        c.add_collective("broadcast", "ib", 1.0)


def test_link_chosen_by_group():
    from repro_torch.launch.roofline import IB_BW, NVLINK_BW, collective_seconds, group_link
    assert group_link(range(8)) == "nvlink"            # one node
    assert group_link(range(8, 16)) == "nvlink"
    assert group_link(range(16)) == "ib"               # a 16-wide model axis spans two nodes
    assert group_link(range(0, 256, 16)) == "ib"       # a data axis group
    assert group_link([0, 4]) == "nvlink"              # data on a (2, 4) mesh
    c = _cost()
    c.add_collective("all-gather", "nvlink", NVLINK_BW)
    c.add_collective("all-reduce", "ib", IB_BW)
    assert collective_seconds(c) == pytest.approx(1.0 + 2.0)
    assert c.collective_counts == {"all-gather": 1, "all-reduce": 1}


def test_step_cost_merged():
    a = _cost(flops=1.0, bytes_accessed=2.0, bytes_bf16eq=2.0)
    a.add_collective("all-reduce", "ib", 4.0)
    b = a.merged(a, mult=3)
    assert (b.flops, b.bytes_accessed, b.collective_bytes) == (4.0, 8.0, 16.0)
    assert b.collective_counts == {"all-reduce": 4} and b.collective_bytes_by_link == {
        ("all-reduce", "ib"): 16.0}
    assert a.flops == 1.0


# ---------------------------------------------------------------- (e) CLI, probe
def test_cli_without_jax_read_by_roofline_table(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.launch.dryrun import main
        raise SystemExit(main(["--arch", "internlm2-1.8b", "--shape", "all", "--mesh", "single",
                               "--smoke", "--outdir", {str(tmp_path)!r}]))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "summary: ok=3 skipped=1 failed=0" in res.stdout
    recs = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"internlm2-1.8b__{s}__single" for s in
                         ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    skipped = recs["internlm2-1.8b__long_500k__single"]
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]
    rec = recs["internlm2-1.8b__train_4k__single"]
    assert rec["status"] == "ok" and rec["remat"] is False and rec["chips"] == 256
    assert "not a measurement" in rec["method"] and rec["microbatches"] == 4
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "peak_estimate_bytes"}
    assert {"flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "collective_counts", "collective_bytes_by_kind"} <= set(rec["cost"])
    sys.path.insert(0, str(ROOT))
    from benchmarks.roofline_table import run
    lines = run(outdir=str(tmp_path))
    assert len(lines) == 4 and lines[-1].startswith("roofline/summary,")
    assert "ok=3;skipped=1;failed=0" in lines[-1]


def test_perfprobe_rows_and_terms():
    code = textwrap.dedent("""
        import json, sys
        sys.modules["jax"] = None
        from repro_torch.launch.dryrun import lower_cell
        from repro_torch.launch.perfprobe import main, probe
        rec, rows = probe("internlm2-1.8b", "train_4k", smoke=True)
        plain = lower_cell("internlm2-1.8b", "train_4k", False, smoke=True)
        assert main(["--arch", "internlm2-1.8b", "--smoke", "--top", "3", "--detail", "2"]) == 0
        print(json.dumps({"rec": rec, "plain": plain,
                          "rows": [[b, f, t, n] for b, f, t, n, _ in rows]}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "top scopes (bytes, x trips):" in res.stdout
    got = json.loads(res.stdout.strip().splitlines()[-1])
    rl, plain = got["rec"]["roofline"], got["plain"]["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rl[term] == plain[term]
    rows = got["rows"]
    top = sum(r[0] for r in rows[:8])
    assert 0 < top <= rl["bytes_per_device"]
    assert sum(r[0] for r in rows) == pytest.approx(rl["bytes_per_device"], rel=1e-9)
    assert any(r[3].startswith("layers.*.") and r[2] == 2 for r in rows)


def test_sharded_execution_still_raises():
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.launch import make_production_mesh, make_train_step
    from repro_torch.models.model import build_model
    model = build_model(get_smoke_config("internlm2-1.8b"), device="meta")
    specs, axes = model.input_records(__import__("repro_torch.configs", fromlist=["SHAPES"])
                                      .SHAPES["train_4k"])
    with pytest.raises(NotImplementedError,
                       match="'data' has size 16 on an abstract mesh, which has no devices"):
        make_train_step(model, make_production_mesh(), TrainConfig(), specs, axes)
    with pytest.raises(NotImplementedError, match="'pod' has size 2 on an abstract mesh"):
        make_train_step(model, make_production_mesh(multi_pod=True), TrainConfig(), specs, axes)
