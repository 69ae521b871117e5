"""LSTM pointer network (paper §III-B, Fig. 1b, Alg. 1) as an ``nn.Module``.

Encoder: an LSTM over the embedded node rows gives the contexts ``C`` and
the final state that seeds the decoder.  Decoder: each step feeds the
embedding of the previously picked node (``dec0`` at step 0) through the
decoder LSTM, refines the query with a glimpse over ``C`` and scores every
node with the pointer head; visited, padded and not-yet-ready nodes (a
parent still unvisited) are masked to ``-1e9``.

Everything is batched over a leading graph dimension and pad-aware through
``n_valid``, with the reference's (``repro.core.ptrnet``) semantics:

* gate order i, f, g, o with ``sigmoid(f + 1)``;
* the encoder state stops updating past ``n_valid``;
* first-occurrence argmax;
* once every real node is visited, the remaining steps drain the padded
  slots in ascending order at zero log-prob and zero entropy (the padded
  rows tie exactly in the reference, whose argmax takes them in order);
* ``dec0 + sys_feat @ w_sys`` only when a profile is given and the
  parameters carry ``w_sys``.

Sampled decode takes its per-step uniforms ``(B, n)`` as an input and picks
by inverse CDF; :func:`repro_torch.core.batching.sample_order` feeds it the
reference's own stream, step ``i`` of a graph drawing
``uniform(fold_in(key, i))``
(:func:`repro_torch.kernels.ptr.decode.step_uniforms`).  Seeded weights
come from :func:`init_params`, the reference's key schedule and draws bit
for bit (:mod:`repro_torch.core.prng`).

The step-invariant products are hoisted: ``C @ W_ref`` of both heads (as
the reference does) and ``emb @ dec.wx`` — every decoder input after step 0
is a row of ``emb``, so the input half of the gate product is one matrix
product per graph instead of one per step.  Same operations, summed in a
different order; orders are held equal to the reference in the tests.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import prng
from .costmodel import SYS_FEAT_DIM

__all__ = ["PointerNet", "init_params", "param_tree", "params_from_numpy", "params_to_numpy",
           "lstm_gates_to_state"]


def _glorot(key, shape) -> np.ndarray:
    # the scale is a float32 square root, as jnp.sqrt takes a Python float
    scale = np.sqrt(np.float32(6.0 / (shape[0] + shape[-1])))
    return prng.uniform(key, shape, -scale, scale)


def init_params(key, feat_dim: int, hidden: int = 256,
                sys_feat_dim: int = SYS_FEAT_DIM) -> dict:
    """The reference's ``init_params`` tree (numpy float32), bit for bit:
    Glorot-uniform matrices from ``split(key, 12)`` (each LSTM splits its
    key once more), zero biases, ``dec0 = 0.1 * normal`` from ``ks[9]`` and
    ``w_sys`` from ``ks[10]``."""
    ks = prng.split(key, 12)

    def lstm(k):
        k1, k2 = prng.split(k)
        return {"wx": _glorot(k1, (hidden, 4 * hidden)), "wh": _glorot(k2, (hidden, 4 * hidden)),
                "b": np.zeros(4 * hidden, np.float32)}

    def head(kr, kq, kv):
        return {"w_ref": _glorot(kr, (hidden, hidden)), "w_q": _glorot(kq, (hidden, hidden)),
                "v": _glorot(kv, (hidden, 1))[:, 0]}

    return {
        "w_in": _glorot(ks[0], (feat_dim, hidden)),
        "b_in": np.zeros(hidden, np.float32),
        "enc": lstm(ks[1]),
        "dec": lstm(ks[2]),
        "glimpse": head(ks[3], ks[4], ks[5]),
        "pointer": head(ks[6], ks[7], ks[8]),
        "dec0": prng.normal(ks[9], (hidden,)) * np.float32(0.1),
        "w_sys": _glorot(ks[10], (sys_feat_dim, hidden)),
    }


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(x, dtype=np.float32)), requires_grad=False)


class LSTMWeights(nn.Module):
    """``gates = x @ wx + h @ wh + b`` with wx, wh of shape (H, 4H)."""

    def __init__(self, wx, wh, b):
        super().__init__()
        self.wx, self.wh, self.b = _param(wx), _param(wh), _param(b)


class AttentionHead(nn.Module):
    """``v . tanh(C @ w_ref + q @ w_q)`` per node."""

    def __init__(self, w_ref, w_q, v):
        super().__init__()
        self.w_ref, self.w_q, self.v = _param(w_ref), _param(w_q), _param(v)


def lstm_gates_to_state(gates: torch.Tensor, c: torch.Tensor):
    """LSTM cell from precomputed gates (..., 4H) in i, f, g, o order."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


class PointerNet(nn.Module):
    """The RESPECT LSTM pointer network.  Parameters mirror the reference's
    pytree: ``w_in``, ``b_in``, ``enc``/``dec`` (``wx``, ``wh``, ``b``),
    ``glimpse``/``pointer`` (``w_ref``, ``w_q``, ``v``), ``dec0`` and the
    optional ``w_sys`` (None when the release has no such leaf)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.w_in = _param(tree["w_in"])
        self.b_in = _param(tree["b_in"])
        self.enc = LSTMWeights(**{k: tree["enc"][k] for k in ("wx", "wh", "b")})
        self.dec = LSTMWeights(**{k: tree["dec"][k] for k in ("wx", "wh", "b")})
        self.glimpse = AttentionHead(**{k: tree["glimpse"][k] for k in ("w_ref", "w_q", "v")})
        self.pointer = AttentionHead(**{k: tree["pointer"][k] for k in ("w_ref", "w_q", "v")})
        self.dec0 = _param(tree["dec0"])
        self.w_sys = _param(tree["w_sys"]) if "w_sys" in tree else None

    @classmethod
    def init(cls, feat_dim: int, hidden: int = 256, *, key,
             sys_feat_dim: int = SYS_FEAT_DIM) -> "PointerNet":
        """Seeded Glorot-uniform init from a JAX-format ``key``
        (:func:`repro_torch.core.prng.PRNGKey`): the reference's
        ``init_params(key, ...)`` weights bit for bit."""
        return cls(init_params(key, feat_dim, hidden, sys_feat_dim))

    @property
    def hidden(self) -> int:
        return int(self.dec0.shape[-1])

    # ------------------------------------------------------------------ #
    def encode(self, feats: torch.Tensor, n_valid: torch.Tensor | None = None):
        """feats (B, n, F) -> contexts C (B, n, H), final (h, c) each (B, H),
        projected embeddings emb (B, n, H).  Rows at or past ``n_valid`` do
        not update the state."""
        B, n, _ = feats.shape
        emb = feats @ self.w_in + self.b_in
        xw = emb @ self.enc.wx
        h = emb.new_zeros(B, self.hidden)
        c = emb.new_zeros(B, self.hidden)
        contexts = []
        for t in range(n):
            hn, cn = lstm_gates_to_state(xw[:, t] + h @ self.enc.wh + self.enc.b, c)
            if n_valid is None:
                h, c = hn, cn
            else:
                live = (n_valid > t)[:, None]
                h = torch.where(live, hn, h)
                c = torch.where(live, cn, c)
            contexts.append(h)
        return torch.stack(contexts, dim=1), (h, c), emb

    def start_token(self, sys_feat: torch.Tensor | None = None) -> torch.Tensor:
        d0 = self.dec0
        if sys_feat is not None and self.w_sys is not None:
            d0 = d0 + sys_feat @ self.w_sys
        return d0

    def plain_logits_fn(self, C: torch.Tensor):
        """The glimpse + pointer step in plain PyTorch with the ``C @ W_ref``
        projections hoisted: ``logits_fn(h, mask) -> (B, n)``."""
        from ..kernels.ptr.ref import precompute_refs, reference_pointer_step
        CWg, CWp = precompute_refs(self, C)
        g, p = self.glimpse, self.pointer
        return lambda h, mask: reference_pointer_step(
            C, CWg, CWp, h, g.w_q, g.v, p.w_q, p.v, mask)

    def decode(self, C, emb, enc_state, parent_mat, *, n_valid=None, uniforms=None,
               logits_fn=None, sys_feat=None, cell=None):
        """Run the whole pointing decode (Alg. 1) for a batch of graphs.

        C, emb: (B, n, H); enc_state: (h, c) each (B, H); parent_mat:
        (B, n, D) int, -1 padded; n_valid: (B,) or None (all real);
        uniforms: (B, n) per-step uniforms for a sampled decode, None for
        greedy; logits_fn(h, mask) overrides the glimpse + pointer step
        (the single-step kernel); cell = (d0, wx, wh, b) overrides the start
        token and the decoder LSTM's weights (the bf16 plain version passes
        rounded copies).  Returns order (B, n) int64 and per-step logp,
        entropy (B, n) float32.

        Differentiable when the parameters require grad (see
        :func:`param_tree`) and ``logits_fn`` is the plain one: REINFORCE
        differentiates logp and entropy (masked logits are -1e9, so their
        probabilities are exactly zero and the masked entropy terms carry
        zero gradient).  A kernel's ``logits_fn`` refuses grad-requiring
        inputs.
        """
        B, n, _ = C.shape
        dev = C.device
        if logits_fn is None:
            logits_fn = self.plain_logits_fn(C)
        if cell is None:
            cell = (self.start_token(sys_feat), self.dec.wx, self.dec.wh, self.dec.b)
        d0, wx, wh, b = cell
        ewx = emb @ wx                                             # (B, n, 4H)
        xw = (d0 @ wx).expand(B, -1)
        h, c = enc_state
        ar = torch.arange(n, device=dev)
        if n_valid is None:
            valid = torch.ones(B, n, dtype=torch.bool, device=dev)
        else:
            valid = ar[None, :] < n_valid.to(dev)[:, None]
        pm = parent_mat.to(device=dev, dtype=torch.long)
        has_parent = pm >= 0
        pm_flat = pm.clamp(min=0).reshape(B, -1)
        visited = torch.zeros(B, n, dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)
        order, logp, ent = [], [], []
        for t in range(n):
            h, c = lstm_gates_to_state(xw + h @ wh + b, c)
            pvis = torch.gather(visited, 1, pm_flat).view(B, n, -1)
            mask = ~visited & valid & torch.where(has_parent, pvis, True).all(dim=-1)
            live = mask.any(dim=-1)
            # once every real node is visited only padded slots remain:
            # drain them at zero logp/entropy
            mask = torch.where(live[:, None], mask, ~visited)
            logits = logits_fn(h, mask)
            logprobs = torch.log_softmax(logits, dim=-1)
            probs = logprobs.exp()
            if uniforms is None:
                idx = torch.argmax(logits, dim=-1)
            else:
                # inverse-CDF pick from one uniform per step; masked slots
                # have exactly zero probability
                cdf = torch.cumsum(probs.detach(), dim=-1)
                draw = uniforms[:, t].to(cdf.dtype) * cdf[:, -1]
                idx = torch.argmax((cdf > draw[:, None]).to(torch.int32), dim=-1)
                last_live = torch.argmax(
                    torch.where(probs > 0, ar[None, :], -1), dim=-1)
                idx = torch.where(cdf[:, -1] > draw, idx, last_live)
            # a drained step takes the first unvisited slot: the padded rows
            # tie exactly in the reference, so its argmax picks them in order
            idx = torch.where(live, idx, torch.argmax((~visited).to(torch.int32), dim=-1))
            e = -torch.where(probs > 0, probs * logprobs, 0.0).sum(dim=-1)
            lp = logprobs[rows, idx]
            order.append(idx)
            logp.append(torch.where(live, lp, 0.0))
            ent.append(torch.where(live, e, 0.0))
            visited[rows, idx] = True
            xw = ewx[rows, idx]
        return torch.stack(order, 1), torch.stack(logp, 1), torch.stack(ent, 1)


def params_from_numpy(tree: dict, device: str | torch.device = "cpu") -> PointerNet:
    """The reference's parameter pytree (nested dicts of numpy arrays or
    tensors) as the port's :class:`PointerNet` on ``device``."""
    def to_np(x):
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return PointerNet(to_np(tree)).to(device)


def param_tree(net: PointerNet) -> dict:
    """The reference's parameter tree of ``net`` with the module's own
    ``nn.Parameter`` objects as leaves (no copies): the tree the optimizer
    and the checkpoints read.  ``net.requires_grad_(True)`` makes the
    network trainable (every parameter is built frozen, for serving)."""
    tree = {"w_in": net.w_in, "b_in": net.b_in, "dec0": net.dec0}
    for name in ("enc", "dec"):
        m = getattr(net, name)
        tree[name] = {k: getattr(m, k) for k in ("wx", "wh", "b")}
    for name in ("glimpse", "pointer"):
        m = getattr(net, name)
        tree[name] = {k: getattr(m, k) for k in ("w_ref", "w_q", "v")}
    if net.w_sys is not None:
        tree["w_sys"] = net.w_sys
    return tree


def params_to_numpy(net: PointerNet) -> dict:
    """The reference's parameter tree (nested dicts of float32 numpy
    copies) of ``net``; the inverse of :func:`params_from_numpy`."""
    def copy(t):
        return ({k: copy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().cpu().numpy().copy())

    return copy(param_tree(net))
