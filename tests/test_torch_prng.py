"""The port's threefry PRNG and seeded init against ``jax.random``.

Every comparison here is bit for bit (tolerance: none):

* ``PRNGKey`` for seeds 0, 1, 42, 2^31 - 1, -1 and 2^31 (JAX keeps the low
  32 bits); ``split``, ``fold_in``, ``bits``, ``uniform`` (default range and
  a min/max) and ``normal`` for 24 keys drawn from a numpy seed, at the
  shapes (), (7,), (3, 5, 7) and (128, 512), and for a stack of keys;
* the float32 ``erf_inv`` and ``log1p`` behind ``normal``, on 131,072
  uniforms spread over all the values ``normal`` can draw, against XLA's
  own compiled ``erf_inv`` applied to the same uniforms;
* every leaf of ``init_params(PRNGKey(0), ...)`` at hidden 64, 96, 128,
  256 and 640, ``dec0`` included;
* the sampled decode's per-step uniforms, one key and a batch of keys,
  against ``repro.kernels.ptr.decode.step_uniforms``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import embed_dim
from repro.core import ptrnet as jptrnet
from repro.kernels.ptr import decode as jdecode
from repro_torch.core import prng
from repro_torch.core import ptrnet as tptrnet
from repro_torch.kernels.ptr.decode import step_uniforms

MAX_DEG = 6
SHAPES = [(), (7,), (3, 5, 7), (128, 512)]
KEYS = [np.asarray(jax.random.PRNGKey(int(s)))
        for s in np.random.default_rng(0).integers(-2**31, 2**31, 24)]


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, 2**31])
def test_prngkey_matches_jax(seed):
    assert _same_bits(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax(shape):
    for key in KEYS:
        jk = jnp.asarray(key)
        assert _same_bits(prng.bits(key, shape), jax.random.bits(jk, shape))
        assert _same_bits(prng.uniform(key, shape), jax.random.uniform(jk, shape))
        assert _same_bits(prng.uniform(key, shape, -0.37, 2.5),
                          jax.random.uniform(jk, shape, minval=-0.37, maxval=2.5))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(shape):
    for key in KEYS[:8]:
        assert _same_bits(prng.normal(key, shape), jax.random.normal(jnp.asarray(key), shape))


def test_split_and_fold_in_match_jax():
    for key in KEYS:
        jk = jnp.asarray(key)
        assert _same_bits(prng.split(key), jax.random.split(jk))
        assert _same_bits(prng.split(key, 12), jax.random.split(jk, 12))
        for data in (0, 1, 7, 1000, 2**31 + 5):
            assert _same_bits(prng.fold_in(key, data), jax.random.fold_in(jk, data))


def test_stacked_keys_draw_per_key():
    keys = np.stack(KEYS[:5])
    assert _same_bits(prng.fold_in(keys, 3), np.stack([prng.fold_in(k, 3) for k in KEYS[:5]]))
    assert _same_bits(prng.split(keys, 3), np.stack([prng.split(k, 3) for k in KEYS[:5]]))
    for fn in (prng.bits, prng.uniform, prng.normal):
        assert _same_bits(fn(keys, (2, 3)), np.stack([fn(k, (2, 3)) for k in KEYS[:5]]))
    with pytest.raises(TypeError):
        prng.uniform(np.zeros(2, np.int32))


def test_erf_inv_and_log1p_match_xla_on_normal_inputs():
    # every 64th of the 2^23 uniforms normal() can draw, through XLA's
    # compiled erf_inv and through the port's written-out float32 version
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0))
    mant = (np.arange(0, 2**23, 64, dtype=np.uint32)) | np.uint32(0x3F800000)
    floats = mant.view(f32) - f32(1.0)
    u = np.maximum(lo, prng._fma(floats, f32(1.0) - lo, lo)).astype(f32)
    want = np.asarray(jax.jit(lambda x: np.float32(np.sqrt(2)) * lax.erf_inv(x))(u))
    got = f32(np.sqrt(2)) * prng._erf_inv_f32(u)
    assert _same_bits(got, want)
    x = np.linspace(-0.999, 4.0, 200_001).astype(f32)
    assert _same_bits(prng._log1p_f32(x), jax.jit(jnp.log1p)(x))


@pytest.mark.parametrize("hidden", [64, 96, 128, 256, 640])
def test_init_params_leaves_match_jax(hidden):
    want = jptrnet.init_params(jax.random.PRNGKey(0), embed_dim(MAX_DEG), hidden)
    got = tptrnet.init_params(prng.PRNGKey(0), embed_dim(MAX_DEG), hidden)
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == 16             # w_sys included
    for path, leaf in flat:
        mine = got
        for p in path:
            mine = mine[p.key]
        assert _same_bits(mine, leaf), jax.tree_util.keystr(path)


def test_pointernet_init_from_key_and_round_trip():
    key = prng.PRNGKey(5)
    net = tptrnet.PointerNet.init(embed_dim(MAX_DEG), 32, key=key)
    tree = tptrnet.params_to_numpy(net)
    want = tptrnet.init_params(key, embed_dim(MAX_DEG), 32)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert all(_same_bits(a, b) for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)))
    again = tptrnet.params_to_numpy(tptrnet.params_from_numpy(tree))
    assert all(_same_bits(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)))


def test_step_uniforms_match_reference():
    key = jax.random.PRNGKey(11)
    got = step_uniforms(np.asarray(key), 37)
    assert got.dtype == torch.float32 and got.shape == (37,)
    assert _same_bits(got.numpy(), jdecode.step_uniforms(key, 37))
    keys = jax.random.split(key, 6)
    want = jax.vmap(lambda k: jdecode.step_uniforms(k, 19))(keys)
    assert _same_bits(step_uniforms(np.asarray(keys), 19).numpy(), want)
    # the stream does not depend on the padded length
    assert _same_bits(step_uniforms(np.asarray(keys), 64).numpy()[:, :19], want)
