"""The port's release-training script (``python -m repro_torch.train_release``)
against the JAX package's ``scripts/train_release.py``, on the CPU.

* the curriculum stream is the reference's: ``FAMILY_MIX``,
  ``_mixed_graphs`` and ``_draw(seed, count, ...)`` give the same graphs
  (parents equal, attributes bit-equal) for the first draws, inside the size
  ramp and past it;
* a short run (``--max-steps 2 --eval-every 1 --batch 16 --n-max 20
  --stage-counts 2,4 --ramp-batches 1``, whose steps move the weights off
  their seeded init) writes a release that both packages'
  ``RespectScheduler.from_release(path)`` load (each verifies the sha256 of
  the parameter bytes), and the two then schedule the ten Table-I graphs
  identically (orders and assignments); the manifest names the port's
  module; a second run with ``--max-steps 3`` resumes from the first's
  checkpoint and draw counter;
* ``--devices 2`` raises as ``RLTrainer`` does (data parallelism is not
  ported).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch import train_release as ttr
from repro_torch.checkpoint import params_sha256, verify_release
from repro_torch.core.ptrnet import param_tree
from repro_torch.core.rl import RLTrainer

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "ref_train_release", Path(__file__).resolve().parents[1] / "scripts" / "train_release.py")
jtr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtr)

# the size ramp off: inside it the first draws hold 5-6 nodes, every reward
# is 1.0, the advantage 0, and the weights would not move
SHORT = ["--max-steps", "2", "--eval-every", "1", "--batch", "16", "--n-max", "20",
         "--stage-counts", "2,4", "--ramp-batches", "1", "--device", "cpu"]


def same_graphs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert [list(p) for p in g.parents] == [list(p) for p in w.parents], i
        for f in ("flops", "param_bytes", "out_bytes"):
            assert np.array_equal(getattr(g, f), getattr(w, f)), (i, f)


def test_family_mix_and_mixed_graphs_match_reference():
    assert ttr.FAMILY_MIX == jtr.FAMILY_MIX
    same_graphs(ttr._mixed_graphs(np.random.default_rng(5), 24, (5, 50)),
                jtr._mixed_graphs(np.random.default_rng(5), 24, (5, 50)))


@pytest.mark.parametrize("count", [0, 1, 2, 31, 63, 64, 200])
def test_draw_stream_matches_reference(count):
    got = ttr._draw(0, count, 16, 5, 50, 64)
    same_graphs(got, jtr._draw(0, count, 16, 5, 50, 64))
    if count < 63:       # inside the ramp the size range is still narrower
        assert max(g.n for g in got) < 50


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    args = SHORT + ["--out", str(root / "rel"), "--ckpt-dir", str(root / "ckpt"),
                    "--label-cache", str(root / "labels")]
    assert ttr.main(args) == 0
    return root, args


def test_release_loads_in_both_packages_and_schedules_identically(release):
    root, _ = release
    path = root / "rel"
    _, manifest = verify_release(path)
    assert manifest["train"]["command"].startswith("python -m repro_torch.train_release ")
    assert manifest["train"]["steps"] == 2 and manifest["train"]["draws"] == 2
    assert manifest["config"] == {"hidden": 128, "feat_dim": tcore.embed_dim(),
                                  "mask_infeasible": True, "max_deg": 6}
    assert manifest["train"]["family_mix"] == list(jtr.FAMILY_MIX)
    init = RLTrainer(hidden=128, seed=0, device="cpu").params
    assert manifest["params_sha256"] != params_sha256(param_tree(init)), "nothing trained"
    ts = tcore.RespectScheduler.from_release(path, device="cpu")
    js = jcore.RespectScheduler.from_release(path)
    assert ts.release["params_sha256"] == js.release["params_sha256"]
    graphs = list(tcore.all_model_graphs().values())
    got = ts.schedule_many(graphs, 4, use_cache=False)
    want = js.schedule_many(list(jcore.all_model_graphs().values()), 4, use_cache=False)
    for i, (r, w) in enumerate(zip(got, want)):
        assert np.array_equal(r["order"], w["order"]), i
        assert np.array_equal(r["assignment"], w["assignment"]), i


def test_rerun_resumes_from_the_checkpoint(release, capsys):
    root, args = release
    args = list(args)
    args[args.index("--max-steps") + 1] = "3"
    assert ttr.main(args) == 0
    assert "[resume] trainer step 2, draw count 2" in capsys.readouterr().out
    assert json.loads((root / "ckpt" / "draw_count.json").read_text()) == {"count": 3}
    _, manifest = verify_release(root / "rel")
    assert manifest["train"]["steps"] == 3 and manifest["train"]["draws"] == 3


def test_data_parallel_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="data parallelism"):
        ttr.main(SHORT + ["--devices", "2", "--out", str(tmp_path / "rel")])
