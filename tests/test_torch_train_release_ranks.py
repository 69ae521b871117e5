"""The release trainer's data parallelism (``python -m repro_torch.train_release
--devices n``) on the CPU, held as ``tests/test_torch_parallel.py`` holds
``train_respect --devices n``.

A short run at hidden 16 and lr 3e-3 (4 steps, global batch 8, stage
counts 2 and 4, evals and checkpoints every 2 draws) on one process and on
two gloo ranks
(``run_ranks``, ``RLTrainer(n_devices=2)``): the two-rank release's
parameters are within 1e-5 of the one-process release's at equal global
batch (the ranks sum their slices' gradients in another order), every
rank's steps, draws, evals and parameter sha256 equal (and equal to rank 0's
release), and a two-rank run stopped after 2 steps and resumed to 4 writes
exactly the release of the uninterrupted two-rank run.
"""

import json

import numpy as np
import torch

from repro_torch import train_release
from repro_torch.checkpoint import verify_release
from repro_torch.core.ptrnet import params_to_numpy
from repro_torch.core.rl import RLTrainer

torch.set_num_threads(1)

TOL_PARAM = 1e-5
RUN = ["--hidden", "16", "--lr", "3e-3", "--batch", "8", "--n-max", "20", "--stage-counts", "2,4",
       "--ramp-batches", "1", "--eval-every", "2", "--save-every", "2", "--device", "cpu"]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _max_diff(a: dict, b: dict) -> float:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    return max(float(np.abs(la[k].astype(np.float64) - lb[k]).max()) for k in la)


def _release(tmp_path, name, steps, *extra):
    args = RUN + ["--label-cache", str(tmp_path / "labels"), "--ckpt-dir", str(tmp_path / name),
                  "--out", str(tmp_path / f"{name}_rel"), "--max-steps", str(steps), *extra]
    assert train_release.main(args) == 0
    params, manifest = verify_release(tmp_path / f"{name}_rel")
    assert manifest["train"]["steps"] == steps == manifest["train"]["draws"]
    assert json.loads((tmp_path / name / "draw_count.json").read_text()) == {"count": steps}
    return params


def test_two_ranks_match_one_and_resume_equals_uninterrupted(tmp_path):
    one = _release(tmp_path, "one", 4)
    two = _release(tmp_path, "two", 4, "--devices", "2", "--backend", "gloo")
    assert _max_diff(two, one) < TOL_PARAM
    _release(tmp_path, "resumed", 2, "--devices", "2", "--backend", "gloo")
    resumed = _release(tmp_path, "resumed", 4, "--devices", "2", "--backend", "gloo")
    assert _max_diff(resumed, two) == 0.0
    init = params_to_numpy(RLTrainer(hidden=16, seed=0, device="cpu").params)
    assert _max_diff(one, init) > 1e-3, "nothing trained"


def test_rank_results_agree(tmp_path):
    from repro_torch.parallel.data import run_ranks
    args = train_release.parse_args(
        RUN + ["--label-cache", str(tmp_path / "labels"), "--ckpt-dir", str(tmp_path / "ck"),
               "--out", str(tmp_path / "rel"), "--max-steps", "2", "--devices", "2"])
    ranks = run_ranks(train_release.train, 2, backend="gloo", device="cpu", timeout_s=600,
                      args=(args, ["--devices", "2"]))
    assert ranks[0] == ranks[1] and ranks[0]["steps"] == 2 == ranks[0]["draws"]
    _, manifest = verify_release(tmp_path / "rel")       # rank 0's release, the ranks' weights
    assert manifest["params_sha256"] == ranks[0]["params_sha256"]
