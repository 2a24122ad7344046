"""Fused flash attention: the Hopper kernels, their plain versions and the
differentiable dispatch.

Five CUDA kernels, each the counterpart of a Pallas kernel of
``chainermn_tpu/ops/flash_attention.py``:

* :func:`flash_attention` -- ``_flash_kernel``, the forward without a
  gradient (eval, serving prefill): bf16 on TMA and ``wgmma``,
  ``csrc/flash_fwd_sm90.cu``; fp32 on CUDA cores, ``csrc/flash_attention.cu``;
* :func:`flash_attention_fwd` -- ``_flash_kernel_lse``, the training
  forward that also writes the row statistic ``lse``, the same kernels with
  their lse store switched on;
* :func:`flash_attention_bwd` -- ``_flash_bwd_fused_kernel``, the fused
  backward: bf16 on TMA and ``wgmma``, ``csrc/flash_bwd_sm90.cu``, with
  its dq epilogue; fp32 on CUDA cores, ``csrc/flash_attention_bwd.cu``;
* :func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv` --
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``, the split
  backward (a dq pass, then a dk/dv pass): bf16 on TMA and ``wgmma``, the
  dq pass ``csrc/flash_bwd_dq_sm90.cu`` and the dk/dv pass the fused
  Hopper kernel with its dq part switched off; fp32 on CUDA cores,
  ``csrc/flash_attention_bwd_split.cu``.

Both backward lowerings start with :func:`flash_attention_bwd_delta`, one
pass for the JAX wrapper's XLA reduce ``delta = rowsum(g * out) - g_lse``
(``csrc/flash_bwd_sm90.cu``), which also zeroes the fused kernel's fp32
dq accumulator.

``attention(q, k, v)`` dispatches on where the tensors lie, as the JAX
``attention`` does on its backends: CUDA tensors that need a gradient go
through :class:`_FlashDiff` (the ``_flash_diff`` custom VJP: the lse
forward, then the backward that ``_FLASH_BWD`` selects); CUDA tensors
without one launch the plain forward kernel; CPU tensors take
:func:`xla_attention` with torch autograd.  :func:`attention_with_lse` is
the ``(out, lse)`` primitive, and on the CPU it takes
:func:`_blockwise_attention_lse_torch`.  A CUDA tensor never falls back to
a plain version: it launches a kernel or raises.

Layout ``[B, H, T, D]`` as in the JAX package.  The kernels read q/k/v/g
through their strides (the last dimension must be dense, rows 16-byte
aligned and no stride 0, else the wrapper makes a contiguous copy) and write
contiguous outputs.  They take bf16 or fp32 at head dim 64 or 128.
"""

from __future__ import annotations

import os

import torch

__all__ = ["attention", "attention_with_lse", "blockwise_attention",
           "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_delta", "xla_attention", "attention_flops",
           "attention_bytes", "attention_bwd_flops", "attention_bwd_bytes"]

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)

#: CHAINERMN_TPU_FLASH_BWD: the backward lowering, as in the JAX package
#: (read once at import, monkeypatchable in tests): "fused" (default) is
#: the one-pass kernel, "split" the two-kernel escape hatch (a dq pass,
#: then a dk/dv pass, each recomputing p).
_FLASH_BWD = os.environ.get("CHAINERMN_TPU_FLASH_BWD", "fused")


def _scale(scale, D):
    return float(scale if scale is not None else 1.0 / (D ** 0.5))


def _causal_mask(Tq, Tk, device):
    """``True`` where key position > query position (masked)."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    return qpos < kpos


def _scores(q, k, causal, scale):
    """fp32 ``scale * q k^T`` of the storage-dtype values (exactly upcast,
    so an fp32 dot is the JAX ``preferred_element_type=float32`` result),
    causal entries set to ``-inf``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    return s


def xla_attention(q, k, v, causal=False, scale=None):
    """Plain PyTorch attention, the reference the kernels are held to.

    Dtype discipline of the JAX ``xla_attention``: the dots take the
    storage-dtype values with fp32 accumulation (done here as fp32 dots of
    the exactly upcast inputs), the softmax runs in fp32, and the
    probabilities are cast to v's dtype before the second dot."""
    s = _scores(q, k, causal, _scale(scale, q.shape[-1]))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _flash_fwd_lse_plain(q, k, v, causal=False, scale=None):
    """Plain version of the lse forward (``_flash_kernel_lse``):
    ``(out, lse)`` with the kernel's rules -- ``m_safe`` is 0 for a row
    with no live key, so that row's out is 0 and its lse the finite
    ``log(1e-30)``; p is cast to v's dtype before the PV dot."""
    s = _scores(q, k, causal, _scale(scale, q.shape[-1]))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m_safe + torch.log(l))[..., 0]


def _bwd_p_ds(q, k, v, g, lse, delta, causal, scale):
    """The backward's recomputed tile, whole: fp32 ``p = exp(s - lse)``
    (0 where masked) and ``ds = p * (g v^T - delta)``."""
    s = _scores(q, k, causal, scale)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    gv = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (gv - delta[..., None])


def _dq_of(ds, q, k, scale):
    """``scale * ds k`` with ds cast to k's dtype, in q's dtype."""
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype)


def _dkv_of(p, ds, q, k, v, g, scale):
    """``(scale * ds^T q, p^T g)`` with ds cast to q's dtype and p to g's,
    in k's and v's dtypes."""
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_delta_plain(g, out, g_lse=None):
    """Plain version of the delta pass: fp32 ``rowsum(g * out) - g_lse``,
    ``[B, H, Tq]``, the JAX wrapper's reduce."""
    delta = (g.float() * out.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _flash_bwd_plain(q, k, v, g, lse, delta, causal=False, scale=None):
    """Plain version of the fused backward on the kernel's inputs (lse and
    ``delta = rowsum(g * out) - g_lse``, both fp32 ``[B, H, Tq]``): fp32
    math with the kernel's casts -- p to g's dtype before the dv dot, ds to
    q's/k's dtype before the dk and dq dots."""
    scale = _scale(scale, q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, g, lse, delta, causal, scale)
    return (_dq_of(ds, q, k, scale), *_dkv_of(p, ds, q, k, v, g, scale))


def _flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=False, scale=None):
    """Plain version of the dq pass (``_flash_bwd_dq_kernel``): dq with ds
    cast to k's dtype before the dot, scaled, in q's dtype."""
    scale = _scale(scale, q.shape[-1])
    _, ds = _bwd_p_ds(q, k, v, g, lse, delta, causal, scale)
    return _dq_of(ds, q, k, scale)


def _flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=False, scale=None):
    """Plain version of the dk/dv pass (``_flash_bwd_dkv_kernel``):
    ``(dk, dv)`` with p cast to g's dtype before the dv dot and ds to q's
    before the dk dot."""
    scale = _scale(scale, q.shape[-1])
    p, ds = _bwd_p_ds(q, k, v, g, lse, delta, causal, scale)
    return _dkv_of(p, ds, q, k, v, g, scale)


def _kernel_view(x):
    """``x`` itself when the kernel can read it through its strides (dense
    last dimension, 16-byte aligned rows, no stride 0 on an extent above 1:
    what a TMA tensor map takes), else a contiguous copy."""
    vec = 16 // x.element_size()
    ok = (x.stride(3) == 1 and x.data_ptr() % 16 == 0
          and all(x.stride(i) % vec == 0 and (x.stride(i) or x.shape[i] == 1)
                  for i in range(3)))
    return x if ok else x.contiguous()


def _check(name, q, k, v):
    """Validate q ``[B, H, Tq, D]``, k/v ``[B, H, Tk, D]`` on one CUDA
    device for a kernel: ``(B, H, Tq, Tk, D)``."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bfloat16 or float32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes [B, H, T, D] tensors")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} has no kernel for head dim {D} "
                         f"(supported: {_HEAD_DIMS})")
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Tq < 1 or Tk < 1:
        raise ValueError(f"{name} needs Tq >= 1 and Tk >= 1")
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(
            f"{name} launches a CUDA kernel: q/k/v must lie on one CUDA "
            "device (CPU tensors take xla_attention via attention())")
    return B, H, Tq, Tk, D


def _on_cpu(*xs):
    """True when every tensor lies on the CPU (the plain versions' only
    device); a mix of devices raises."""
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({x.device for x in xs}) != 1:
        raise ValueError(f"tensors lie on {sorted(map(str, kinds))}: the "
                         "kernels take one CUDA device, the plain versions "
                         "the CPU")
    return False


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


#: SMs of the card the tiles are chosen for (H100 SXM)
_SMS = 132


def _fwd_block_k(B, H, Tq, D):
    """Keys per tile of the bf16 forward (its q tiles are 64 rows), by the
    H100 measurements of ``tools/flash_fwd_tiles.py`` (PERF.md): 64 where
    ``B * H * ceil(Tq / 64)`` blocks give every SM three (the training
    shape; three fit at D 64), else 128 at D 64 (a serving prefill at B 1:
    fewer, longer steps on the critical path).  D 128 takes 64 (registers)."""
    if D == 128 or B * H * -(-Tq // 64) >= 3 * _SMS:
        return 64
    return 128


_fwd_launcher = None


def _fwd_kernel():
    """The library's ``flash_attention_fwd``, looked up once."""
    global _fwd_launcher
    if _fwd_launcher is None:
        from .._build import load_library
        _fwd_launcher = load_library().flash_attention_fwd
    return _fwd_launcher


def _launch_fwd(name, q, k, v, causal, scale, with_lse):
    """Launch the forward kernel: ``(out, lse or None)``."""
    B, H, Tq, Tk, D = _check(name, q, k, v)
    scale = _scale(scale, D)
    launch = _fwd_kernel()
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    dev = q.device
    out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
           if with_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _DTYPES[q.dtype], B, H, Tq, Tk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), scale, _fwd_block_k(B, H, Tq, D))
    if dev.index == torch.cuda.current_device():
        err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None):
    """Launch the CUDA flash kernel (no gradient).  q: ``[B, H, Tq, D]``,
    k/v: ``[B, H, Tk, D]`` on one CUDA device, bf16 or fp32, D in (64,
    128).  Raises for anything the kernel does not take, including inputs
    that need a gradient (:func:`attention` routes those to the lse
    forward and the backward kernel); counts each launch in
    ``flash_attention.launches``."""
    if _needs_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention is the no-grad forward and has no backward: "
            "take attention() (the lse forward + fused backward) for "
            "inputs that need a gradient")
    out, _ = _launch_fwd("flash_attention", q, k, v, causal, scale, False)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """The lse forward: ``(out, lse)``, lse fp32 ``[B, H, Tq]``.  CUDA
    tensors launch the kernel (counted in ``flash_attention_fwd.launches``);
    CPU tensors take :func:`_flash_fwd_lse_plain`."""
    if _on_cpu(q, k, v):
        return _flash_fwd_lse_plain(q, k, v, causal=causal, scale=scale)
    out, lse = _launch_fwd("flash_attention_fwd", q, k, v, causal, scale,
                           True)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _flash_bwd_mode():
    mode = _FLASH_BWD
    if mode not in ("fused", "split"):
        raise ValueError(
            f"CHAINERMN_TPU_FLASH_BWD={mode!r} invalid (fused|split)")
    return mode


def _bwd_inputs(name, q, k, v, g, lse, delta):
    """Validate a backward kernel's inputs on one CUDA device: its
    dimensions ``(B, H, Tq, Tk, D)`` and the tensors as the kernel reads
    them (q/k/v/g through their strides, lse and delta contiguous)."""
    dims = B, H, Tq, Tk, D = _check(name, q, k, v)
    if g.dtype != q.dtype or g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g must match q: got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}, q {q.dtype} {tuple(q.shape)}")
    for what, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B, H, Tq) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(f"{what} must be fp32 {(B, H, Tq)} on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    views = [_kernel_view(x) for x in (q, k, v, g)]
    return dims, views + [lse.contiguous(), delta.contiguous()]


_bwd_launchers = {}


def _launch(name, dev, *args):
    """Call the library's launcher ``name`` (looked up once) with ``args``
    and the current stream of ``dev``, making ``dev`` current only when it
    is not; raise on a CUDA error."""
    launch = _bwd_launchers.get(name)
    if launch is None:
        from .._build import load_library
        launch = _bwd_launchers[name] = getattr(load_library(), name)
    if dev.index == torch.cuda.current_device():
        err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch_bwd(name, dims, ins, outs, causal, scale):
    """Launch the backward kernel ``name`` of the library on the inputs
    of :func:`_bwd_inputs` into the preallocated ``outs``."""
    B, H, Tq, Tk, D = dims
    q, k, v, g = ins[:4]
    _launch(name, q.device,
            *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
            _DTYPES[q.dtype], B, H, Tq, Tk, D,
            *(x.stride(i) for x in (q, k, v, g) for i in range(3)),
            int(bool(causal)), scale)


def _launch_delta(g, out, g_lse, dq_zero):
    """Launch the delta pass on CUDA ``g`` and ``out`` ``[B, H, Tq, D]``
    (``g_lse`` fp32 ``[B, H, Tq]`` or None): fp32 delta ``[B, H, Tq]``;
    ``dq_zero``, an fp32 ``[B, H, Tq, D]`` buffer or None, is zeroed in the
    same pass.  Counted in ``flash_attention_bwd_delta.launches``."""
    if g.dtype not in _DTYPES or out.dtype != g.dtype or g.dim() != 4 \
            or out.shape != g.shape or g.shape[-1] not in _HEAD_DIMS \
            or out.device != g.device or g.device.type != "cuda":
        raise ValueError(f"the delta pass takes g and out of one shape "
                         f"[B, H, Tq, D], D in {_HEAD_DIMS}, bfloat16 or "
                         f"float32, on one CUDA device: got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}, {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    B, H, Tq, D = g.shape
    if g_lse is not None:
        if g_lse.shape != (B, H, Tq) or g_lse.device != g.device:
            raise ValueError(f"g_lse must be {(B, H, Tq)} on {g.device}, "
                             f"got {tuple(g_lse.shape)} on {g_lse.device}")
        g_lse = g_lse.float().contiguous()
    g, out = _kernel_view(g), _kernel_view(out)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=g.device)
    _launch("flash_attention_bwd_delta", g.device, g.data_ptr(),
            out.data_ptr(), None if g_lse is None else g_lse.data_ptr(),
            delta.data_ptr(), None if dq_zero is None else dq_zero.data_ptr(),
            _DTYPES[g.dtype], B, H, Tq, D, *g.stride()[:3],
            *out.stride()[:3])
    flash_attention_bwd_delta.launches += 1
    return delta


def flash_attention_bwd_delta(g, out, g_lse=None):
    """The backward's row statistic ``delta = rowsum(g * out) - g_lse``,
    fp32 ``[B, H, Tq]``.  CUDA tensors launch the delta pass (counted in
    ``flash_attention_bwd_delta.launches``); CPU tensors take
    :func:`_bwd_delta_plain`."""
    if _on_cpu(g, out, *(() if g_lse is None else (g_lse,))):
        return _bwd_delta_plain(g, out, g_lse)
    return _launch_delta(g, out, g_lse, None)


flash_attention_bwd_delta.launches = 0


def _fused_bwd(q, k, v, out, lse, g, causal, scale, g_lse):
    """The fused backward on CUDA tensors: the delta pass (which zeroes
    the fp32 dq accumulator), then the kernel and its dq epilogue.
    Returns ``(dq_acc, dq, dk, dv)``: ``dq_acc`` is the unscaled fp32 sum
    the epilogue scales and casts into dq."""
    B, H, Tq, Tk, D = _check("flash_attention_bwd", q, k, v)
    dq_acc = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    delta = _launch_delta(g, out, g_lse, dq_acc)
    dims, ins = _bwd_inputs("flash_attention_bwd", q, k, v, g, lse, delta)
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, Tk, D), dtype=v.dtype, device=q.device)
    _launch_bwd("flash_attention_bwd", dims, ins, (dq_acc, dq, dk, dv),
                causal, scale)
    flash_attention_bwd.launches += 1
    return dq_acc, dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, causal=False, scale=None,
                        g_lse=None):
    """Backward of :func:`flash_attention_fwd`: ``(dq, dk, dv)``.

    ``g_lse``: optional cotangent of lse; since d lse_i / d s_ij = p_ij it
    enters as ``delta - g_lse``, as in the JAX wrapper.  ``_FLASH_BWD``
    selects the lowering: ``"fused"`` launches the delta pass, then the
    fused kernel with its dq epilogue on CUDA tensors (counted in
    ``flash_attention_bwd_delta.launches`` and
    ``flash_attention_bwd.launches``) and takes :func:`_flash_bwd_plain`
    on CPU tensors; ``"split"`` runs :func:`flash_attention_bwd_delta`,
    :func:`flash_attention_bwd_dq`, then :func:`flash_attention_bwd_dkv`."""
    mode = _flash_bwd_mode()
    scale = _scale(scale, q.shape[-1])
    if mode == "split":
        delta = flash_attention_bwd_delta(g, out, g_lse)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=causal,
                                    scale=scale)
        return (dq, *flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                             causal=causal, scale=scale))
    if _on_cpu(q, k, v, g, out):
        return _flash_bwd_plain(q, k, v, g, lse,
                                _bwd_delta_plain(g, out, g_lse),
                                causal=causal, scale=scale)
    return _fused_bwd(q, k, v, out, lse, g, causal, scale, g_lse)[1:]


flash_attention_bwd.launches = 0


def flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=False,
                           scale=None):
    """The split backward's dq pass on the kernels' inputs (lse and
    ``delta``, fp32 ``[B, H, Tq]``): dq in q's dtype.  CUDA tensors launch
    the kernel (counted in ``flash_attention_bwd_dq.launches``); CPU
    tensors take :func:`_flash_bwd_dq_plain`."""
    scale = _scale(scale, q.shape[-1])
    if _on_cpu(q, k, v, g):
        return _flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                   scale=scale)
    dims, ins = _bwd_inputs("flash_attention_bwd_dq", q, k, v, g, lse,
                            delta)
    B, H, Tq, Tk, D = dims
    dq = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    _launch_bwd("flash_attention_bwd_dq", dims, ins, (dq,), causal, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=False,
                            scale=None):
    """The split backward's dk/dv pass on the kernels' inputs: ``(dk,
    dv)`` in k's and v's dtypes.  CUDA tensors launch the kernel (counted
    in ``flash_attention_bwd_dkv.launches``); CPU tensors take
    :func:`_flash_bwd_dkv_plain`."""
    scale = _scale(scale, q.shape[-1])
    if _on_cpu(q, k, v, g):
        return _flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                    scale=scale)
    dims, ins = _bwd_inputs("flash_attention_bwd_dkv", q, k, v, g, lse,
                            delta)
    B, H, Tq, Tk, D = dims
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, Tk, D), dtype=v.dtype, device=q.device)
    _launch_bwd("flash_attention_bwd_dkv", dims, ins, (dk, dv), causal,
                scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class _FlashDiff(torch.autograd.Function):
    """Differentiable flash attention (the JAX ``_flash_diff`` custom
    VJP): the lse forward, saving q, k, v, out and lse, then the backward
    (:func:`flash_attention_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


class _FlashLseDiff(torch.autograd.Function):
    """Differentiable ``(out, lse)`` (the JAX ``_flash_lse_diff``): the
    backward passes lse's cotangent as ``g_lse``.  A ``None`` cotangent is
    zero: with only lse used, g is zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return None, None, None, None, None
        if g is None:
            g = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal, scale=ctx.scale,
                                         g_lse=g_lse)
        return dq, dk, dv, None, None


def attention(q, k, v, causal=False, scale=None):
    """Dispatch on the tensors' device: on CUDA the lse forward and
    backward kernels when a gradient is needed, else the no-grad forward
    kernel; on the CPU the plain version under torch autograd."""
    if q.device.type == "cuda":
        if _needs_grad(q, k, v):
            return _FlashDiff.apply(q, k, v, causal, scale)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    return xla_attention(q, k, v, causal=causal, scale=scale)


def _blockwise_attention_lse_torch(q, k, v, causal, scale, block_k=512):
    """Blockwise ``(out, lse)`` in plain torch, the port of the JAX
    ``_blockwise_attention_lse_jnp``: scans KV blocks with the online
    softmax, never holding a ``[Tq, Tk]`` score matrix; differentiable by
    torch autograd.  A ragged Tk is padded to a block multiple and the
    padded keys masked.  Its masked-row rule is the JAX function's: a row
    with no live key has out 0 and lse ``-inf`` (the kernel's is finite)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    block_k = min(block_k, Tk)
    nb = -(-Tk // block_k)
    pad = nb * block_k - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    m = torch.full((B, H, Tq, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc = torch.zeros((B, H, Tq, D), device=q.device)
    for bi in range(nb):
        k_blk = k[:, :, bi * block_k:(bi + 1) * block_k]
        v_blk = v[:, :, bi * block_k:(bi + 1) * block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float()) * scale
        k_pos = bi * block_k + torch.arange(block_k, device=q.device)[None]
        valid = k_pos < Tk
        if causal:
            valid = valid & (q_pos >= k_pos)
        if causal or pad:
            s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                        torch.zeros_like(s))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd",
                                        p.to(v.dtype).float(), v_blk.float())
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe).to(q.dtype)
    m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = (m_fin + torch.log(l_safe))[..., 0]
    lse = torch.where(torch.isfinite(m[..., 0]), lse,
                      torch.full_like(lse, float("-inf")))
    return out, lse


def attention_with_lse(q, k, v, causal=False, scale=None):
    """Differentiable attention returning ``(out, lse)`` (lse fp32
    ``[B, H, Tq]``), the primitive that lets attention blocks be merged
    exactly (ring attention).  CUDA: the lse forward and fused backward
    kernels (any shape the kernels take); CPU: the blockwise plain
    version.  Neither holds a ``[Tq, Tk]`` score matrix in device
    memory."""
    scale = _scale(scale, q.shape[-1])
    if q.device.type == "cuda":
        return _FlashLseDiff.apply(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    return _blockwise_attention_lse_torch(q, k, v, causal, scale)


def blockwise_attention(q, k, v, causal=False, scale=None):
    """Memory-bounded attention: :func:`attention_with_lse`'s output."""
    return attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


def _live_pairs(Tq, Tk, causal):
    if causal:
        return sum(min(q + 1, Tk) for q in range(Tq))
    return Tq * Tk


def attention_flops(B, H, Tq, Tk, D, causal):
    """Multiply-adds x2 of QK^T and PV that the inputs need: with
    ``causal`` only the (q, k) pairs with k <= q count."""
    return 4 * B * H * D * _live_pairs(Tq, Tk, causal)


def attention_bytes(B, H, Tq, Tk, D, itemsize):
    """Bytes read and written once each: q, k, v in, out back."""
    return (2 * B * H * Tq * D + 2 * B * H * Tk * D) * itemsize


#: per backward kernel: (dots per live (q, k) pair, [Tq, D] and [Tk, D]
#: tensors it moves).  fused: q k^T, g v^T, p^T g, ds^T q, ds k; q, g, dq
#: and k, v, dk, dv.  dq pass: q k^T, g v^T, ds k; q, g, dq and k, v.
#: dk/dv pass: q k^T, g v^T, p^T g, ds^T q; q, g and k, v, dk, dv.
_BWD_WORK = {"fused": (5, 3, 4), "dq": (3, 3, 2), "dkv": (4, 2, 4)}


def attention_bwd_flops(B, H, Tq, Tk, D, causal, part="fused"):
    """Multiply-adds x2 of a backward kernel's dots (``part``: ``fused``,
    ``dq`` or ``dkv``) over the live (q, k) pairs."""
    return 2 * _BWD_WORK[part][0] * B * H * D * _live_pairs(Tq, Tk, causal)


def attention_bwd_bytes(B, H, Tq, Tk, D, itemsize, part="fused"):
    """Bytes a backward kernel must move once each: its q/k-shaped inputs
    and outputs (``_BWD_WORK``) and the fp32 lse and delta in."""
    _, n_q, n_k = _BWD_WORK[part]
    return ((n_q * Tq * D + n_k * Tk * D) * itemsize + 2 * Tq * 4) * B * H
