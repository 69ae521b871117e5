"""The port's int8 compressed all-reduce (``repro_torch.optim.compress``)
against the reference's ``repro.optim.compress``, on the CPU.

* ``int8_compress``/``int8_decompress``: payload and scale equal, the
  decompressed tensor bitwise equal.
* ``compressed_all_reduce`` on 4 gloo ranks (each rank all-reduces its row
  of a stacked tree) against ``compressed_psum`` under ``jax.vmap(...,
  axis_name="data")`` over the same rows, which needs no forced devices:
  the int8 payloads and the int32 totals equal, the means and the error
  trees bitwise equal, in a first round and in a second round fed the
  first round's error feedback.  The reference's payload and totals are
  its own arithmetic (``compress.py:45-50``) written out under the same
  vmap, since ``compressed_psum`` returns neither.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro_torch.optim import compress
from repro_torch.parallel.data import run_ranks

torch.set_num_threads(1)

N_RANKS = 4


def _tree(rng, scale: float = 1.0) -> dict:
    """A stacked (rank-leading) float32 tree: a large leaf, a nested small
    one, an all-zero one (its scale falls back to 1) and a scalar a rank."""
    return {"w": (rng.normal(size=(N_RANKS, 64, 33)) * scale).astype(np.float32),
            "head": {"v": (rng.normal(size=(N_RANKS, 17)) * 1e-3 * scale).astype(np.float32),
                     "z": np.zeros((N_RANKS, 5), np.float32)},
            "b": (rng.normal(size=(N_RANKS,)) * scale).astype(np.float32)}


def _reference(stacked: dict, err: dict | None):
    """``compressed_psum`` under vmap over the rank axis, and the payload and
    totals of its arithmetic."""
    def one(t, e):
        means, errs = jcompress.compressed_psum(t, "data", e)

        def payload(g, ee):
            g32 = g.astype(jnp.float32) + (ee if ee is not None else 0.0)
            amax = jax.lax.pmax(jnp.max(jnp.abs(g32)), "data")
            scale = jnp.where(amax > 0, amax / 127.0, 1.0)
            q = jnp.clip(jnp.round(g32 / scale), -127, 127).astype(jnp.int8)
            return q, jax.lax.psum(q.astype(jnp.int32), "data")

        ee = jax.tree.map(lambda _: None, t) if e is None else e
        parts = jax.tree.map(payload, t, ee, is_leaf=lambda x: x is None)
        return means, errs, parts

    jt = jax.tree.map(jnp.asarray, stacked)
    if err is None:
        out = jax.vmap(lambda t: one(t, None), axis_name="data")(jt)
    else:
        out = jax.vmap(one, axis_name="data")(jt, jax.tree.map(jnp.asarray, err))
    return jax.tree.map(np.asarray, out)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _stack(rows: list[dict]) -> dict:
    """Per-rank numpy trees -> one tree with a leading rank axis."""
    def st(*xs):
        return np.stack(xs)
    return jax.tree.map(st, *rows)


def test_int8_compress_matches_reference():
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(64, 33)).astype(np.float32),
              (rng.normal(size=(9,)) * 1e-6).astype(np.float32),
              np.zeros((4, 4), np.float32)):
        q, scale = compress.int8_compress(torch.from_numpy(x))
        jq, jscale = jcompress.int8_compress(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
        got = compress.int8_decompress(q, scale).numpy()
        want = np.asarray(jcompress.int8_decompress(jq, jscale))
        assert got.tobytes() == want.tobytes()


def test_compressed_all_reduce_matches_reference_on_four_ranks():
    rng = np.random.default_rng(1)
    first, second = _tree(rng), _tree(rng, scale=0.5)
    # round 1 without error feedback, round 2 fed round 1's error trees
    out1 = run_ranks(compress.compressed_all_reduce_rows, N_RANKS, backend="gloo",
                     device="cpu", timeout_s=240, args=(first, None))
    err1 = _stack([o["err"] for o in out1])
    out2 = run_ranks(compress.compressed_all_reduce_rows, N_RANKS, backend="gloo",
                     device="cpu", timeout_s=240, args=(second, err1))
    for stacked, err, out in ((first, None, out1), (second, err1, out2)):
        jmean, jerr, jparts = _reference(stacked, err)
        got = {k: _stack([o[k] for o in out]) for k in ("mean", "err", "q", "total")}
        want_q = jax.tree.map(lambda p: p[0], jparts, is_leaf=lambda x: isinstance(x, tuple))
        want_t = jax.tree.map(lambda p: p[1], jparts, is_leaf=lambda x: isinstance(x, tuple))
        for name, want in (("mean", jmean), ("err", jerr), ("q", want_q), ("total", want_t)):
            for (path, g), (_, w) in zip(_leaves(got[name]), _leaves(want)):
                assert g.dtype == w.dtype, (name, path)
                assert g.tobytes() == w.tobytes(), (name, path)
        # the mean is the mean up to the int8 quantization (the reference's bound)
        exact = {p: v.mean(0) for p, v in _leaves(stacked)}
        for path, m in _leaves(got["mean"]):
            if path.endswith("z"):
                assert not m.any()
                continue
            want = exact[path] + (0 if err is None else dict(_leaves(err))[path].mean(0))
            rel = np.abs(m[0] - want).max() / (np.abs(want).max() + 1e-9)
            assert rel < 0.02, path


def test_compressed_all_reduce_with_one_rank_is_its_quantization():
    rng = np.random.default_rng(2)
    one = jax.tree.map(lambda a: a[:1], _tree(rng))
    out = run_ranks(compress.compressed_all_reduce_rows, 1, backend="gloo", device="cpu",
                    timeout_s=240, args=(one, None))[0]
    for (path, m), (_, e), (_, x) in zip(_leaves(out["mean"]), _leaves(out["err"]),
                                         _leaves(one)):
        q, scale = compress.int8_compress(torch.from_numpy(np.array(x[0])))
        assert m.tobytes() == compress.int8_decompress(q, scale).numpy().tobytes(), path
        np.testing.assert_array_equal(e, x[0] - m)
    with pytest.raises(ValueError, match="backend"):
        run_ranks(compress.compressed_all_reduce_rows, 1, backend="mpi", device="cpu",
                  args=(one, None))
