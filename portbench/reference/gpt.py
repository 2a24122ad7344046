"""GPT-2 training loss, plain float32 PyTorch.

Radford et al. 2019 (GPT-2; the block of its released code): token and
position embeddings, then pre-norm blocks

    h = x + proj(attention(ln1(x)))      q, k, v from one product, heads
                                         of d / n_head, causal softmax of
                                         q k^T / sqrt(d_head)
    x = h + fc2(gelu_tanh(fc1(ln2(h))))  4x MLP

then a final layer norm, the output head and the mean next-token
cross-entropy.  Departures from the released model, as the configuration
states them: no dropout, and an output head of its own (not tied to the
token embedding).  Attention is the plain quadratic product with the
mask applied before the softmax.  The loss is summed over blocks of rows
(each block's backward before the next block's forward) so that the
float32 step fits.  With a ``precision`` below float32 every tensor the
configuration holds in its compute type (the embeddings' sum, each layer
norm's output, each product's weights, bias and output, the attention
probabilities before their product with v, the GELU's output, each
residual sum) is cast to it (``quant``); the loss is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .quant import rounding

__all__ = ["param_specs", "loss_and_grads"]


def param_specs(cfg):
    """``[(name, shape, init)]``: GPT-2's initialization (normal, std
    0.02; the projections into the residual stream 0.02 / sqrt(2 L);
    position embeddings 0.01; biases 0; layer norms 1 and 0)."""
    d, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]
    std = cfg["initializer_range"]
    resid = std / math.sqrt(2 * L)
    specs = [("/embed/W", (V, d), ("normal", std)),
             ("/pos_embed/W", (cfg["n_positions"], d), ("normal", 0.01))]
    for i in range(L):
        b = f"/blocks/{i}"
        specs += [(f"{b}/ln1/gamma", (d,), ("const", 1.0)),
                  (f"{b}/ln1/beta", (d,), ("const", 0.0)),
                  (f"{b}/attn/qkv/W", (3 * d, d), ("normal", std)),
                  (f"{b}/attn/qkv/b", (3 * d,), ("const", 0.0)),
                  (f"{b}/attn/proj/W", (d, d), ("normal", resid)),
                  (f"{b}/attn/proj/b", (d,), ("const", 0.0)),
                  (f"{b}/ln2/gamma", (d,), ("const", 1.0)),
                  (f"{b}/ln2/beta", (d,), ("const", 0.0)),
                  (f"{b}/fc1/W", (4 * d, d), ("normal", std)),
                  (f"{b}/fc1/b", (4 * d,), ("const", 0.0)),
                  (f"{b}/fc2/W", (d, 4 * d), ("normal", resid)),
                  (f"{b}/fc2/b", (d,), ("const", 0.0))]
    specs += [("/ln_f/gamma", (d,), ("const", 1.0)),
              ("/ln_f/beta", (d,), ("const", 0.0)),
              ("/head/W", (V, d), ("normal", std))]
    return specs


def _linear(r, x, W, b=None):
    """A product in the compute type: the weights cast, the output cast."""
    return r.cast(TF.linear(x, r.cast(W), None if b is None else r.cast(b)))


def _attention(q, k, v, r):
    """Causal softmax attention; the probabilities are cast before their
    product with v, as the flash kernels round them."""
    T = q.shape[-2]
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return r.cast(r.cast(p) @ v)


def loss_sum(cfg, p, x, t, precision="float32"):
    """The summed next-token cross-entropy of the rows ``x`` (token ids
    ``[B, T]``) against ``t``."""
    r = rounding(precision)
    d, H, eps = cfg["n_embd"], cfg["n_head"], cfg["layer_norm_epsilon"]
    B, T = x.shape
    h = r.cast(p["/embed/W"][x] + p["/pos_embed/W"][:T])
    for i in range(cfg["n_layer"]):
        b = f"/blocks/{i}"
        a = r.cast(TF.layer_norm(h, (d,), p[f"{b}/ln1/gamma"],
                                 p[f"{b}/ln1/beta"], eps))
        qkv = _linear(r, a, p[f"{b}/attn/qkv/W"], p[f"{b}/attn/qkv/b"])
        q, k, v = qkv.reshape(B, T, 3, H, d // H).permute(2, 0, 3, 1, 4)
        o = _attention(q, k, v, r).transpose(1, 2).reshape(B, T, d)
        h = r.cast(h + _linear(r, o, p[f"{b}/attn/proj/W"],
                               p[f"{b}/attn/proj/b"]))
        m = r.cast(TF.layer_norm(h, (d,), p[f"{b}/ln2/gamma"],
                                 p[f"{b}/ln2/beta"], eps))
        m = r.cast(TF.gelu(_linear(r, m, p[f"{b}/fc1/W"], p[f"{b}/fc1/b"]),
                           approximate="tanh"))
        h = r.cast(h + _linear(r, m, p[f"{b}/fc2/W"], p[f"{b}/fc2/b"]))
    h = r.cast(TF.layer_norm(h, (d,), p["/ln_f/gamma"], p["/ln_f/beta"],
                             eps))
    logits = _linear(r, h, p["/head/W"])
    return TF.cross_entropy(logits.reshape(B * T, -1), t.reshape(-1).long(),
                            reduction="sum")


def loss_and_grads(cfg, precision="float32", rows_per_block=4):
    """``fn(params, (x, t)) -> (mean loss, {name: gradient})`` for
    ``reference.train_readings``, summed over blocks of
    ``rows_per_block`` rows."""
    def fn(params, batch):
        x, t = batch
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        names, tensors = list(leaves), list(leaves.values())
        n_tokens = t.numel()
        total, grads = 0.0, None
        for i in range(0, x.shape[0], rows_per_block):
            part = loss_sum(cfg, leaves, x[i:i + rows_per_block],
                            t[i:i + rows_per_block], precision) / n_tokens
            g = torch.autograd.grad(part, tensors)
            total += float(part.detach())
            grads = list(g) if grads is None else [
                a.add_(b) for a, b in zip(grads, g)]
        return torch.tensor(total), dict(zip(names, grads))
    return fn
