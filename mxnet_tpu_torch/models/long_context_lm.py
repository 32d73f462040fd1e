"""The long-context causal language model.

Port of ``example/long-context/train_lm.py`` (its function names kept): a
small causal transformer — token embedding plus learned positions
(``max_len`` 4096), then per layer a parameter-free norm -> qkv ->
``ring_attention(causal=True)`` -> proj and a norm -> ff1 -> relu -> ff2
residual block; the head is tied to the embedding (``norm(x) @
embed.T``).  The example's published widths are its command-line
defaults: d_model 64, 4 heads, 2 layers, d_ff 256 (4 x d_model), vocab
128, seq 512, batch 4, lr 0.3.

Parameters are a nested dict of plain tensors (the JAX params pytree):
``embed`` (vocab, d), ``pos`` (1, max_len, d) and ``l{i}`` -> ``qkv``,
``proj``, ``ff1``, ``ff2``.  On one device (no mesh, or a mesh whose
``sp`` axis has one device) attention is ``full_attention``, which takes
the flash kernel for sequences above ``MXTPU_FLASH_BLOCK``; a mesh with
``sp`` > 1 raises (the ring across devices comes with the multi-GPU
slice).  ``params_from_numpy`` / ``params_to_numpy`` carry the JAX
pytree's arrays over (``convert.tree_from_numpy`` / ``tree_to_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import current_context
from ..convert import tree_from_numpy, tree_to_numpy
from ..parallel.ring_attention import ring_attention

__all__ = ["build_params", "apply_model", "make_step", "markov_batch",
           "params_from_numpy", "params_to_numpy", "UPDATE_RANGE"]

#: the ``torch.profiler.record_function`` range around each step's SGD
#: update (a profile attributes the kernels launched inside it)
UPDATE_RANGE = "long_context_lm.update"

params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy


def build_params(generator, vocab, d_model, n_heads, n_layers, d_ff,
                 max_len=4096, ctx=None):
    """Random parameters in the example's structure and scales (normal:
    0.02 for the embeddings, 1/sqrt(d_model) for qkv, proj and ff1,
    1/sqrt(d_ff) for ff2), drawn from ``generator`` on its own device and
    placed on ``ctx`` (the current context when None), float32."""
    dev = (ctx if ctx is not None else current_context()).torch_device
    s = 1.0 / np.sqrt(d_model)

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(dev)

    params = {"embed": normal((vocab, d_model), 0.02),
              "pos": normal((1, max_len, d_model), 0.02)}
    for i in range(n_layers):
        params["l%d" % i] = {
            "qkv": normal((d_model, 3 * d_model), s),
            "proj": normal((d_model, d_model), s),
            "ff1": normal((d_model, d_ff), s),
            "ff2": normal((d_ff, d_model), 1.0 / np.sqrt(d_ff)),
        }
    return params


def _norm(z):
    """Parameter-free norm over the last axis: population variance (as
    ``jnp.var``), epsilon 1e-5."""
    mu = z.mean(-1, keepdim=True)
    var = z.var(-1, keepdim=True, unbiased=False)
    return (z - mu) / torch.sqrt(var + 1e-5)


def apply_model(params, tokens, mesh, n_heads, n_layers):
    """tokens (B, T) integer ids -> logits (B, T, V)."""
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    B, T = tokens.shape
    D = embed.shape[1]
    hd = D // n_heads
    x = embed[tokens] + params["pos"][:, :T]
    for i in range(n_layers):
        p = params["l%d" % i]
        qkv = _norm(x) @ p["qkv"]
        # views of the one product: the kernel takes their strides
        q, k, v = qkv.split(D, dim=-1)
        q = q.reshape(B, T, n_heads, hd)
        k = k.reshape(B, T, n_heads, hd)
        v = v.reshape(B, T, n_heads, hd)
        att = ring_attention(q, k, v, mesh=mesh, axis_name="sp",
                             causal=True)
        x = x + att.reshape(B, T, D) @ p["proj"]
        x = x + torch.relu(_norm(x) @ p["ff1"]) @ p["ff2"]
    return _norm(x) @ embed.t()


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def make_step(mesh, n_heads, n_layers, lr):
    """The example's training step: ``step(params, tokens, targets) ->
    (params, loss)``, the mean next-token NLL of the log-softmax, its
    gradients by torch autograd and plain SGD ``p -= lr * g``.  Unlike
    the JAX step (pure, with donated buffers) it updates the parameter
    tensors in place and returns the same dict; the loss is a 0-d tensor
    on the device (no host sync inside the step)."""

    def step(params, tokens, targets):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        targets = torch.as_tensor(targets, device=leaves[0].device).long()
        with torch.enable_grad():
            logits = apply_model(params, tokens, mesh, n_heads, n_layers)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
            loss = nll.mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), torch.profiler.record_function(UPDATE_RANGE):
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        return params, loss.detach()

    return step


def markov_batch(rs, succ, batch, seq_len, vocab):
    """The example's synthetic batches, byte for byte: each token follows
    one of its row of ``succ`` with probability 0.9, else a uniform one
    from [1, vocab).  ``rs`` is a ``numpy.random.RandomState``."""
    toks = np.zeros((batch, seq_len + 1), np.int32)
    toks[:, 0] = rs.randint(1, vocab, batch)
    for t in range(seq_len):
        nxt = succ[toks[:, t], rs.randint(0, succ.shape[1], batch)]
        rnd = rs.randint(1, vocab, batch)
        use = rs.rand(batch) < 0.9
        toks[:, t + 1] = np.where(use, nxt, rnd)
    return toks[:, :-1], toks[:, 1:].astype(np.int32)

