"""Flash attention: the training path's attention core, forward and backward.

:func:`flash_attention` takes ``[batch, seq, heads, head_dim]`` inputs, as
the JAX package's does, folds them to ``[batch*heads, seq, head_dim]`` and
runs three kernels of ``csrc/flash_attention.cu``:

- ``flash_fwd`` (:func:`flash_fwd`): o and the fp32 row log-sum-exp;
- ``flash_dq`` (:func:`flash_dq`): dq, and delta = rowsum(dO * O), which it
  stores for the next kernel;
- ``flash_dkv`` (:func:`flash_dkv`): dk and dv.

:class:`FlashAttentionFunction` (a ``torch.autograd.Function``) wires them
as the reference's ``jax.custom_vjp`` does. Each wrapper launches its kernel
for CUDA tensors and runs its plain torch version (``flash_fwd_plain``,
``flash_dq_plain``, ``flash_dkv_plain``: the explicit formulas over
materialized scores) for CPU tensors; there is no fallback, a CUDA input
the kernel does not take raises.

Masking: a column is visible to row r when ``col < limit`` (``limit`` is
the static true length of a padded sequence, and the runtime per-row
``vl[bh]`` key-padding limit where given) and, under causal, ``col <= r``.
Rows with no visible column give unspecified output, as in the reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..debug import check_nans

_NEG_INF = -1e30  # finite: exp(_NEG_INF - m) == 0 exactly, no inf-inf NaNs

# Kernel launches by the wrappers, per kernel. Only a launch adds to it.
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# The folded [bh, L, D] shapes each kernel launched at since the last reset.
SHAPES: dict = {k: set() for k in LAUNCHES}

HEAD_DIMS = (64, 128)  # the kernels' instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_IDS = {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 2}
_MAX_SMEM = 232448  # H100: dynamic shared memory one block may opt into


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SHAPES[k].clear()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _visible(L: int, limit: int, vl, causal: bool, device):
    """[bh or 1, L, L] bool: column visible to row."""
    cols = torch.arange(L, device=device)
    lim = torch.full((1,), min(limit, L), dtype=torch.long, device=device)
    if vl is not None:
        lim = torch.minimum(vl.long(), lim)
    vis = cols[None, None, :] < lim[:, None, None]
    if causal:
        vis = vis & (cols[None, None, :] <= cols[None, :, None])
    return vis


def _scores(q, k, *, causal, sm_scale, limit, vl):
    """s = (scale * q) k^T in fp32 with hidden scores at -1e30."""
    s = torch.einsum("bqd,bkd->bqk", q.float() * sm_scale, k.float())
    vis = _visible(q.shape[1], limit, vl, causal, q.device)
    return torch.where(vis, s, torch.full((), _NEG_INF, device=q.device))


def _probs(q, k, lse, **kw):
    """p = exp(s - lse), recomputed from the forward's lse, fp32."""
    return torch.exp(_scores(q, k, **kw) - lse[..., None])


def flash_fwd_plain(q, k, v, *, causal: bool, sm_scale: float, limit: int,
                    vl=None):
    """(o [bh, L, D] in q's dtype, lse [bh, L] fp32) by the explicit
    softmax over materialized fp32 scores."""
    s = _scores(q, k, causal=causal, sm_scale=sm_scale, limit=limit, vl=vl)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lc = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / lc
    return o.to(q.dtype), (m + torch.log(lc))[..., 0]


def flash_dq_plain(q, k, v, o, do, lse, *, causal: bool, sm_scale: float,
                   limit: int, vl=None):
    """(dq in q's dtype, delta [bh, L] fp32): delta = rowsum(dO * O),
    ds = p (dO V^T - delta), dq = scale * ds K."""
    p = _probs(q, k, lse, causal=causal, sm_scale=sm_scale, limit=limit,
               vl=vl)
    delta = (do.float() * o.float()).sum(-1)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = sm_scale * torch.einsum("bqk,bkd->bqd", ds, k.float())
    return dq.to(q.dtype), delta


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal: bool,
                    sm_scale: float, limit: int, vl=None):
    """(dk, dv) in k's dtype: dv = p^T dO, dk = scale * ds^T Q."""
    p = _probs(q, k, lse, causal=causal, sm_scale=sm_scale, limit=limit,
               vl=vl)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = sm_scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(kernel: str, tensors: dict, vl):
    q = tensors["q"]
    bh, L, D = q.shape
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        shape = (bh, L) if name in ("lse", "delta") else (bh, L, D)
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)}, expected "
                f"{want} {shape}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} kernel: dtype {q.dtype} not in (float32, "
                        "bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"{kernel} kernel: head_dim {D} not in {HEAD_DIMS} (the "
            "kernel's instantiations)"
        )
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {q.device}")
    if vl is not None and (vl.dtype != torch.int32 or tuple(vl.shape) != (bh,)
                           or vl.device != q.device
                           or not vl.is_contiguous()):
        raise ValueError(f"{kernel}: vl must be a contiguous int32 [bh={bh}] "
                         f"tensor on {q.device}")
    if bh >= 2**31 or -(-L // 64) > 65535:
        raise ValueError(f"{kernel} kernel: grid (bh={bh}, L={L}) exceeds "
                         "the launch limits")


def _lib(kernel: str, head_dim: int):
    from ._build import load

    lib = _bind(load("flash_attention"))
    smem = lib.ddl_flash_smem_bytes(_KERNEL_IDS[kernel], head_dim)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"{kernel} kernel: head_dim {head_dim} needs {smem} "
                         f"B of shared memory, over {_MAX_SMEM}")
    return lib


def _raise_on(lib, kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{lib.ddl_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal: bool, sm_scale: float, limit: int,
              vl=None):
    """Forward over folded [bh, L, D]: (o, lse fp32 [bh, L])."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               limit=limit, vl=vl)
    _check("flash_fwd", {"q": q, "k": k, "v": v}, vl)
    bh, L, D = q.shape
    lib = _lib("flash_fwd", D)
    o = torch.empty_like(q)
    lse = torch.empty(bh, L, dtype=torch.float32, device=q.device)
    err = lib.ddl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(vl), o.data_ptr(),
        lse.data_ptr(), bh, L, D, int(limit), int(causal), float(sm_scale),
        _DTYPE_CODES[q.dtype], _stream(q),
    )
    _raise_on(lib, "flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    SHAPES["flash_fwd"].add((bh, L, D))
    check_nans("flash_fwd", o, lse)
    return o, lse


def flash_dq(q, k, v, o, do, lse, *, causal: bool, sm_scale: float,
             limit: int, vl=None):
    """Backward, first kernel: (dq, delta fp32 [bh, L])."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, o, do, lse, causal=causal,
                              sm_scale=sm_scale, limit=limit, vl=vl)
    _check("flash_dq", {"q": q, "k": k, "v": v, "o": o, "do": do,
                        "lse": lse}, vl)
    bh, L, D = q.shape
    lib = _lib("flash_dq", D)
    dq = torch.empty_like(q)
    delta = torch.empty(bh, L, dtype=torch.float32, device=q.device)
    err = lib.ddl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), _ptr(vl), dq.data_ptr(),
        delta.data_ptr(), bh, L, D, int(limit), int(causal), float(sm_scale),
        _DTYPE_CODES[q.dtype], _stream(q),
    )
    _raise_on(lib, "flash_dq", err)
    LAUNCHES["flash_dq"] += 1
    SHAPES["flash_dq"].add((bh, L, D))
    check_nans("flash_dq", dq, delta)
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
              limit: int, vl=None):
    """Backward, second kernel (after :func:`flash_dq`, whose delta it
    reads): (dk, dv)."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                               sm_scale=sm_scale, limit=limit, vl=vl)
    _check("flash_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                         "delta": delta}, vl)
    bh, L, D = q.shape
    lib = _lib("flash_dkv", D)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.ddl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(vl), dk.data_ptr(),
        dv.data_ptr(), bh, L, D, int(limit), int(causal), float(sm_scale),
        _DTYPE_CODES[q.dtype], _stream(q),
    )
    _raise_on(lib, "flash_dkv", err)
    LAUNCHES["flash_dkv"] += 1
    SHAPES["flash_dkv"].add((bh, L, D))
    check_nans("flash_dkv", dk, dv)
    return dk, dv


def _bind(lib):
    """Declare the C signatures once per loaded library (ctypes would pass
    a Python int pointer as a 32-bit int without them)."""
    if getattr(lib, "_ddl_bound", False):
        return lib
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32, i32, i32, i32, i32, f32, i32, vp]  # bh L D limit causal ...
    lib.ddl_flash_fwd.argtypes = [vp] * 6 + tail
    lib.ddl_flash_bwd_dq.argtypes = [vp] * 9 + tail
    lib.ddl_flash_bwd_dkv.argtypes = [vp] * 9 + tail
    for fn in (lib.ddl_flash_fwd, lib.ddl_flash_bwd_dq,
               lib.ddl_flash_bwd_dkv):
        fn.restype = i32
    lib.ddl_flash_smem_bytes.argtypes = [i32, i32]
    lib.ddl_flash_smem_bytes.restype = ctypes.c_longlong
    lib.ddl_cuda_error_string.argtypes = [i32]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    lib._ddl_bound = True
    return lib


# ---------------------------------------------------------------------------
# autograd and the public API
# ---------------------------------------------------------------------------


class FlashAttentionFunction(torch.autograd.Function):
    """o = flash(q, k, v) over folded [bh, L, D], differentiable in q, k, v
    through the two backward kernels (the reference's ``_flash``
    custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, vl, causal: bool, sm_scale: float, limit: int):
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                           limit=limit, vl=vl)
        ctx.save_for_backward(q, k, v, vl, o, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, limit=limit)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, vl, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_dq(q, k, v, o, do, lse, vl=vl, **ctx.opts)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, vl=vl, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None, block_q: int = 128,
                    block_k: int = 128, kv_valid_lens=None):
    """Fused attention over ``[batch, seq, heads, head_dim]`` inputs:
    ``softmax(scale * Q K^T [+ causal mask]) V`` with an fp32 softmax, in
    q's dtype, differentiable through the flash backward kernels.

    A sequence that is no multiple of the blocks is right-padded to one
    common block, as the reference does (the padded columns are hidden by
    the static limit, the padded rows sliced off). ``kv_valid_lens``
    ([batch] int): per-sequence key-padding limit, a contiguous-prefix key
    mask.
    """
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    vl = None
    if kv_valid_lens is not None:
        vl = torch.as_tensor(kv_valid_lens, dtype=torch.int32,
                             device=q.device)
        if tuple(vl.shape) != (b,):
            raise ValueError(f"kv_valid_lens must be [batch]={b}, got "
                             f"{tuple(vl.shape)}")
        vl = vl.repeat_interleave(h).contiguous()  # b-major, like the fold
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq == 0 and s % bk == 0:
        s_p = s
    else:
        bq = min(bq, bk)
        s_p = -(-s // bq) * bq
        pad = (0, 0, 0, 0, 0, s_p - s)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s_p, d).contiguous()

    o = FlashAttentionFunction.apply(fold(q), fold(k), fold(v), vl, causal,
                                     float(sm_scale), s)
    o = o.reshape(b, h, s_p, d).permute(0, 2, 1, 3)
    return o[:, :s] if s_p != s else o


def attention_reference(q, k, v, *, causal: bool = False, sm_scale=None):
    """Plain oracle over [batch, seq, heads, head_dim] (materialized fp32
    scores), the reference's ``attention_reference``."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        ql, kl = s.shape[-2], s.shape[-1]
        mask = torch.ones(ql, kl, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s,
                        torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
