"""The SSD scan's autograd Function (``repro_torch.kernels.ssd.ops.SsdScan``)
against ``jax.grad`` of the reference's ``ssd_scan(impl="chunked")`` — what
the reference trains through off the TPU (autodiff of
``reference_ssd_chunked``; the Pallas kernel has no VJP).

Inputs drawn with numpy from a seed and fed to both; the loss is a fixed
random weighting of y and of h_final, so both outputs' cotangents are
exercised.  Gradients to x, dt, A, B, C (and in_scale where given) within
atol = rtol = 1e-5 x max(1, max|g|) (float32 sums in another order;
measured at most 5.7e-6 absolute at |g| up to 44).  Cases: Mamba-2's tying
(in_scale None) and mLSTM's decoupled in_scale, S = 12 against a chunk of 8
(the padding, differentiated by torch above the Function), two groups of
heads; and a loss that reads y alone (h_final's cotangent None).  A ``cuda``
test holds the kernel path's gradients to the plain path's on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops

torch.set_num_threads(1)

SHAPE = dict(bt=2, s=12, h=4, p=8, g=2, n=8, chunk=8)


def _inputs(in_scale: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    bt, s, h, p, g, n = (SHAPE[k] for k in ("bt", "s", "h", "p", "g", "n"))
    out = [rng.standard_normal((bt, s, h, p)),
           np.log1p(np.exp(rng.standard_normal((bt, s, h)) * 0.5 - 1.0)),
           np.exp(rng.standard_normal(h) * 0.2),
           rng.standard_normal((bt, s, g, n)),
           rng.standard_normal((bt, s, g, n))]
    if in_scale:
        out.append(rng.random((bt, s, h)))
    wy = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    wh = rng.standard_normal((bt, h, n, p)).astype(np.float32)
    return [a.astype(np.float32) for a in out], wy, wh


def _check(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("read_state", [True, False], ids=["y_and_state", "y_only"])
@pytest.mark.parametrize("in_scale", [False, True], ids=["mamba2", "mlstm_in_scale"])
def test_gradients_match_jax_chunked(in_scale, read_state):
    args, wy, wh = _inputs(in_scale)
    chunk = SHAPE["chunk"]

    def jloss(*a):
        y, hf = jax_ssd_scan(*a[:5], chunk=chunk, impl="chunked",
                             in_scale=a[5] if in_scale else None)
        return jnp.sum(y * wy) + (jnp.sum(hf * wh) if read_state else 0.0)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(*args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, hf = ops.ssd_scan(*leaves[:5], chunk=chunk, in_scale=leaves[5] if in_scale else None)
    loss = (y * torch.from_numpy(wy)).sum()
    if read_state:
        loss = loss + (hf * torch.from_numpy(wh)).sum()
    loss.backward()
    assert y.shape == (SHAPE["bt"], SHAPE["s"], SHAPE["h"], SHAPE["p"])
    for leaf, want in zip(leaves, jgrads):
        assert leaf.grad is not None and leaf.grad.dtype == leaf.dtype
        _check(leaf.grad.numpy(), np.asarray(want))


def test_function_only_in_grad_mode():
    """Without a grad-requiring input, or under no_grad, ``ssd_scan`` runs
    the plain version (no autograd graph); with one, the Function's."""
    args, _, _ = _inputs(False)
    ts = [torch.from_numpy(a) for a in args]
    y, _ = ops.ssd_scan(*ts, chunk=8)
    assert y.grad_fn is None
    x = ts[0].clone().requires_grad_(True)
    y, hf = ops.ssd_scan(x, *ts[1:], chunk=8)
    assert "SsdScanBackward" in type(hf.grad_fn).__name__
    with torch.no_grad():
        assert ops.ssd_scan(x, *ts[1:], chunk=8)[0].grad_fn is None


@pytest.mark.cuda
def test_kernel_path_gradients_on_cuda():
    """On the card the forward is B4 (counted), its y and h_final and the
    gradients equal the plain path's; ``ssd_scan_cuda`` refuses
    grad-requiring inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from repro_torch.kernels.ssd.kernel import ssd_scan_cuda
    args, wy, wh = _inputs(True, seed=1)
    grads, outs = [], []
    for dev in ("cuda", "cpu"):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in args]
        before = build.LAUNCHES["ssd_scan"]
        y, hf = ops.ssd_scan(*leaves[:5], chunk=8, in_scale=leaves[5])
        assert build.LAUNCHES["ssd_scan"] == before + (dev == "cuda")
        outs.append([t.detach().cpu().numpy() for t in (y, hf)])
        ((y * torch.from_numpy(wy).to(dev)).sum()
         + (hf * torch.from_numpy(wh).to(dev)).sum()).backward()
        grads.append([t.grad.cpu().numpy() for t in leaves])
        if dev == "cuda":
            with pytest.raises(RuntimeError, match="no gradient"):
                ssd_scan_cuda(*leaves[:5], chunk=8)
    for got, want in zip(outs[0] + grads[0], outs[1] + grads[1]):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4)
