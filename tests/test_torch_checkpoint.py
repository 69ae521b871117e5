"""The port's release reader and weight carry-over against the reference.

* ``checkpoints/respect-v1`` loads into torch tensors and its recomputed
  ``params_sha256`` is the pinned ``04314bd4...`` — the reference's digest;
* a flipped byte, a truncated leaf and a missing manifest key each raise
  ``ReleaseError``;
* ``params_from_numpy`` of the reference's ``ptrnet.init_params`` gives a
  module whose encode (allclose 1e-5) and greedy decode (equal orders,
  logp/entropy allclose 1e-4) match the reference's;
* the write side: ``RespectScheduler.save`` is read by the reference's
  ``load_pytree_dict`` and ``RespectScheduler.load`` with identical leaves
  and the reference's manifest (names, order, keys); the reference's
  ``save`` and a legacy flat ``.npz`` load into the port; a stale ``.tmp``
  directory is replaced; a round trip keeps the schedules.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.checkpoint import load_pytree_dict as jax_load_pytree_dict
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.checkpoint.release import params_sha256 as jax_params_sha256
from repro.checkpoint.release import verify_release as jax_verify_release
from repro.core import ptrnet as jptrnet
from repro.core import sample_dag
from repro.core.costmodel import PipelineSystem as JSystem
from repro.core.embedding import embed_dim, embed_graph
from repro_torch.checkpoint import (ReleaseError, find_release, load_pytree_dict,
                                    params_sha256, save_pytree, verify_release)
from repro_torch.core import RespectScheduler
from repro_torch.core import sample_batch as tsample_batch
from repro_torch.core.ptrnet import params_from_numpy, params_to_numpy

# one intra-op thread: the suite runs in several worker processes at once,
# and per-process thread pools would oversubscribe the cores
torch.set_num_threads(1)

PINNED = "04314bd4c7fbaf45e6e2461746c133e5a74fb5a3b1794c1c3d894c4272d4df20"
MAX_DEG = 6


@pytest.fixture(scope="module")
def release_dir():
    path = find_release()
    assert path is not None and path.name == "respect-v1"
    return path


def test_release_loads_into_torch_with_pinned_digest(release_dir):
    params, manifest = verify_release(release_dir)
    assert manifest["params_sha256"] == PINNED
    assert params_sha256(params) == PINNED
    leaves = [v for d in params.values() for v in (d.values() if isinstance(d, dict) else [d])]
    assert len(leaves) == 15 and all(isinstance(x, torch.Tensor) for x in leaves)
    assert all(x.dtype == torch.float32 for x in leaves)
    assert "w_sys" not in params and params["dec0"].shape == (128,)
    assert params["w_in"].shape == (embed_dim(MAX_DEG), 128)
    # same digest as the reference computes over its own load
    jparams, _ = jax_verify_release(release_dir)
    assert jax_params_sha256(jparams) == PINNED
    for name in ("w_in", "dec0"):
        assert np.array_equal(params[name].numpy(), np.asarray(jparams[name]))


def _copy(release_dir, tmp_path):
    dst = tmp_path / "respect-v1"
    shutil.copytree(release_dir, dst)
    return dst


def _leaf_file(rel, name):
    manifest = json.loads((rel / "params" / "manifest.json").read_text())
    entry = next(e for e in manifest["leaves"] if e["name"] == name)
    return rel / "params" / entry["file"]


def test_flipped_byte_raises(release_dir, tmp_path):
    rel = _copy(release_dir, tmp_path)
    f = _leaf_file(rel, "dec/wh")
    data = bytearray(f.read_bytes())
    data[1000] ^= 0x01
    f.write_bytes(bytes(data))
    with pytest.raises(ReleaseError, match="digest mismatch"):
        verify_release(rel)
    with pytest.raises(ReleaseError):
        RespectScheduler.from_release(rel, device="cpu")


@pytest.mark.parametrize("cut", [4, 3])
def test_truncated_leaf_raises(release_dir, tmp_path, cut):
    rel = _copy(release_dir, tmp_path)
    f = _leaf_file(rel, "enc/wx")
    f.write_bytes(f.read_bytes()[:-cut])
    with pytest.raises(ReleaseError, match="unreadable"):
        verify_release(rel)


@pytest.mark.parametrize("key", ["params_sha256", "train", "config"])
def test_missing_manifest_key_raises(release_dir, tmp_path, key):
    rel = _copy(release_dir, tmp_path)
    m = json.loads((rel / "release.json").read_text())
    del m[key]
    (rel / "release.json").write_text(json.dumps(m))
    with pytest.raises(ReleaseError, match="missing required keys"):
        verify_release(rel)


def test_missing_leaf_file_raises(release_dir, tmp_path):
    rel = _copy(release_dir, tmp_path)
    _leaf_file(rel, "pointer/v").unlink()
    with pytest.raises(ReleaseError):
        verify_release(rel)


def test_release_without_infeasible_mask_raises(release_dir, tmp_path):
    rel = _copy(release_dir, tmp_path)
    m = json.loads((rel / "release.json").read_text())
    m["config"]["mask_infeasible"] = False
    (rel / "release.json").write_text(json.dumps(m))
    verify_release(rel)                  # the weights themselves are intact
    with pytest.raises(ReleaseError, match="mask_infeasible"):
        RespectScheduler.from_release(rel, device="cpu")


def test_no_release_falls_back_with_warning(monkeypatch, tmp_path):
    monkeypatch.setenv("RESPECT_CHECKPOINT", str(tmp_path / "nowhere"))
    assert find_release() is None
    with pytest.warns(RuntimeWarning, match="no trained release"):
        sched = RespectScheduler.from_release(device="cpu", hidden=32)
    assert sched.release is None and sched.hidden == 32


def test_load_pytree_dict_rebuilds_nested_names(release_dir):
    tree = load_pytree_dict(release_dir / "params")
    assert set(tree) == {"w_in", "b_in", "enc", "dec", "glimpse", "pointer", "dec0"}
    assert set(tree["glimpse"]) == {"w_ref", "w_q", "v"}


@pytest.mark.parametrize("with_profile", [False, True])
def test_params_from_numpy_matches_jax_encode_and_decode(with_profile):
    jparams = jptrnet.init_params(jax.random.PRNGKey(3), embed_dim(MAX_DEG), 32)
    net = params_from_numpy(jax.tree.map(np.asarray, jparams))
    assert net.w_sys is not None
    g = sample_dag(np.random.default_rng(4), n=14, deg=3)
    feats, pmat = embed_graph(g, MAX_DEG), g.parent_matrix(MAX_DEG)
    profile = JSystem(n_stages=4, link_bw=(1e8, 2e8, 4e8, 8e8)).profile_features()
    sys_feat = profile if with_profile else None

    jC, (jh, jc), jemb = jptrnet.encode(jparams, feats)
    jo, jl, je = jptrnet.greedy_order(jparams, feats, pmat, sys_feat=sys_feat)
    with torch.inference_mode():
        C, (h, c), emb = net.encode(torch.from_numpy(feats)[None])
        for got, want in ((C[0], jC), (h[0], jh), (c[0], jc), (emb[0], jemb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        o, lp, e = net.decode(C, emb, (h, c), torch.from_numpy(pmat)[None],
                              sys_feat=None if sys_feat is None else torch.from_numpy(sys_feat))
    assert np.array_equal(o[0].numpy(), np.asarray(jo))
    np.testing.assert_allclose(lp[0].numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(e[0].numpy(), np.asarray(je), atol=1e-4)


def _leaves_equal(a: dict, b: dict) -> bool:
    fa = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, a))[0]
    fb = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, b))[0]
    return ([jax.tree_util.keystr(p) for p, _ in fa] == [jax.tree_util.keystr(p) for p, _ in fb]
            and all(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
                    for (_, x), (_, y) in zip(fa, fb)))


def test_port_save_is_read_by_the_reference(tmp_path):
    sched = RespectScheduler.init(seed=2, hidden=32, device="cpu")
    sched.save(tmp_path / "port")
    tree = params_to_numpy(sched.net)
    assert _leaves_equal(jax_load_pytree_dict(tmp_path / "port"), tree)
    assert _leaves_equal(jcore.RespectScheduler.load(tmp_path / "port").params, tree)
    # the same manifest as the reference writes for the same tree
    jax_save_pytree(tree, tmp_path / "ref")
    port = json.loads((tmp_path / "port" / "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert port == ref
    assert [e["name"] for e in port["leaves"]][:6] == ["b_in", "dec/b", "dec/wh", "dec/wx",
                                                        "dec0", "enc/b"]
    for e in port["leaves"]:
        assert (tmp_path / "port" / e["file"]).read_bytes() == \
            (tmp_path / "ref" / e["file"]).read_bytes()


def test_reference_save_and_legacy_npz_load_into_the_port(tmp_path):
    jsched = jcore.RespectScheduler.init(seed=6, hidden=32)
    jsched.save(tmp_path / "ref")
    want = jax.tree.map(np.asarray, jsched.params)
    assert _leaves_equal(params_to_numpy(RespectScheduler.load(tmp_path / "ref", device="cpu").net),
                         want)
    # the legacy flat dump: keystr paths as keys
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    np.savez(tmp_path / "legacy.npz", **{jax.tree_util.keystr(p): v for p, v in flat})
    assert "['enc']['wx']" in np.load(tmp_path / "legacy.npz").files
    port = RespectScheduler.load(tmp_path / "legacy.npz", device="cpu")
    assert _leaves_equal(params_to_numpy(port.net), want)
    assert _leaves_equal(jcore.RespectScheduler.load(tmp_path / "legacy.npz").params, want)


def test_save_replaces_a_stale_tmp_and_round_trips(tmp_path):
    target = tmp_path / "ckpt"
    stale = target.with_suffix(".tmp")
    stale.mkdir()
    (stale / "junk.bin").write_bytes(b"partial write")
    sched = RespectScheduler.init(seed=1, hidden=32, device="cpu")
    sched.save(target)
    assert not stale.exists()
    assert sorted(p.name for p in target.iterdir())[-1] == "manifest.json"
    save_pytree({"a": np.arange(3, dtype=np.float32)}, target)      # over an existing one
    assert load_pytree_dict(target)["a"].tolist() == [0.0, 1.0, 2.0]
    sched.save(target)
    back = RespectScheduler.load(target, device="cpu")
    graphs = tsample_batch(np.random.default_rng(2), 6, n=(9, 30))
    for a, b in zip(back.schedule_many(graphs, 4, use_cache=False),
                    sched.schedule_many(graphs, 4, use_cache=False)):
        assert np.array_equal(a["order"], b["order"])
        assert np.array_equal(a["assignment"], b["assignment"])
