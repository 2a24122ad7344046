"""Operations and bytes from shapes, and the chip's peaks: the yardstick
of every utilization and roofline share the benchmark reports.

Counts are of what the inputs need, never of what a kernel happens to do:
a matrix product of ``m x k`` by ``k x n`` is ``2 m n k`` operations,
batch norm, activations, pooling and the loss are not counted (the MFU
convention), recomputation is not counted, and causal attention counts
only the ``(q, k)`` pairs with ``k <= q``.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, data sheet, dense (no sparsity), at its 700 W limit:
#: bf16 / fp16 tensor-core operations per second and HBM3 bytes per second
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


# -- ResNet (bottleneck, v1.5: the stride on the 3x3) ----------------------

def _conv_out(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def resnet_convs(blocks, widths, image, n_classes, expansion=4):
    """The multiply-adds of each product of one image's forward pass, in
    order: ``(name, multiply_adds)``, the first convolution first and the
    classifier last."""
    out = []
    h = _conv_out(image, 7, 2, 3)
    out.append(("conv1", h * h * 64 * 3 * 7 * 7))
    h = _conv_out(h, 3, 2, 1)            # max pooling
    c_in = 64
    for stage, (n, mid) in enumerate(zip(blocks, widths)):
        c_out = mid * expansion
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            h_out = _conv_out(h, 3, stride, 1)
            name = f"res{stage + 2}/{i}"
            out.append((f"{name}/a", h * h * mid * c_in))
            out.append((f"{name}/b", h_out * h_out * mid * mid * 9))
            out.append((f"{name}/c", h_out * h_out * c_out * mid))
            if i == 0:
                out.append((f"{name}/shortcut", h_out * h_out * c_out * c_in))
            h, c_in = h_out, c_out
    out.append(("fc", c_in * n_classes))
    return out


def resnet_forward_flops(blocks, widths, image, n_classes):
    """Operations of one image's forward pass: 2 x the multiply-adds of
    its convolutions and classifier."""
    return 2 * sum(m for _, m in resnet_convs(blocks, widths, image,
                                               n_classes))


def resnet_train_flops(blocks, widths, image, n_classes):
    """Operations of one image's training step: the forward, the weight
    gradient of every product and the input gradient of every product
    but the first convolution, whose input (the image) needs none: 3 x
    the forward less the first convolution's input gradient."""
    convs = resnet_convs(blocks, widths, image, n_classes)
    return 2 * (3 * sum(m for _, m in convs) - convs[0][1])


# -- GPT-2 block stack (pre-norm, 4x MLP, untied head) ---------------------

def gpt_train_flops_per_token(d_model, n_layers, n_vocab, seq_len,
                              causal=True):
    """Operations of one token's training step, 3 x its forward: the
    products of the blocks (12 d^2 a layer: q, k, v, the projection and
    the 4x MLP) and of the head (d V), and attention's two products over
    the keys the token sees, (T + 1) / 2 of them on average when causal,
    T otherwise.  The embedding lookups are not products."""
    weights = 12 * n_layers * d_model ** 2 + d_model * n_vocab
    keys = (seq_len + 1) / 2 if causal else seq_len
    attention = 2 * n_layers * d_model * keys
    return 3 * 2 * (weights + attention)


# -- the flash attention kernels -------------------------------------------

def live_pairs(Tq, Tk, causal):
    """The ``(q, k)`` pairs a causal mask keeps (query ``q`` sees keys
    ``0..q``), or all of them."""
    if causal:
        n = min(Tq, Tk)
        return n * (n + 1) // 2 + max(Tq - Tk, 0) * Tk
    return Tq * Tk


def attention_fwd_flops(B, H, Tq, Tk, D, causal):
    """The forward's products, ``q k^T`` and ``p v``, over the live pairs."""
    return 4 * B * H * D * live_pairs(Tq, Tk, causal)


def attention_fwd_bytes(B, H, Tq, Tk, D, itemsize, lse=True):
    """Bytes the forward must move once each: q, k and v in, the output
    and (with ``lse``) the fp32 log-sum-exp out."""
    return ((2 * Tq * D + 2 * Tk * D) * itemsize + (4 * Tq if lse else 0)) \
        * B * H


def attention_bwd_flops(B, H, Tq, Tk, D, causal):
    """The fused backward's products over the live pairs: ``q k^T`` and
    ``g v^T`` again, then ``p^T g``, ``ds^T q`` and ``ds k``.  The two
    recomputed products are part of the algorithm here: the backward
    cannot be had from q, k, v, g and the lse without them."""
    return 2 * 5 * B * H * D * live_pairs(Tq, Tk, causal)


def attention_bwd_bytes(B, H, Tq, Tk, D, itemsize):
    """Bytes the backward must move once each: q, k, v, the output and
    its gradient g in, dq, dk and dv out (q, o, g, dq and k, v, dk, dv),
    and the fp32 lse in."""
    return ((4 * Tq * D + 4 * Tk * D) * itemsize + 4 * Tq) * B * H


def bound_s(flops, nbytes):
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM rate, and which of the two."""
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
