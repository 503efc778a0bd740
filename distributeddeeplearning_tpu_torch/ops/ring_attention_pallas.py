"""Ring attention with fused block kernels: the ring of
:mod:`ops.ring_attention` with the per-visit block attention in three
hand-written kernels of ``csrc/ring_attention.cu`` (the JAX package's
``ops/ring_attention_pallas.py``; ``ring_pallas`` keeps its name).

The ring stays in Python: :func:`comms.ring_shift` rotates the KV block one
neighbour per visit. Each visit folds the block into this rank's carries:

- ``ring_step`` (:func:`ring_step`): the online-softmax carries (m, l, acc),
  fp32, from pre-scaled fp32 queries;
- ``ring_dq`` (:func:`ring_dq`): dq += scale * ds K, p recomputed from
  (q, k, lse), ds = p (dO V^T - delta);
- ``ring_dkv`` (:func:`ring_dkv`): dv += p^T dO and dk += scale * ds^T Q onto
  the dk/dv that rotate with the block.

Mode 0 keeps every score of the block; mode 1 (the diagonal block) the local
causal ``row >= col``. Blocks of higher ranks (hidden under causal) get no
launch. Each wrapper launches its kernel for CUDA tensors and runs its plain
torch version (``*_plain``) for CPU tensors; there is no fallback, a CUDA
input the kernel does not take raises. Every wrapper returns fresh tensors:
the dk/dv it accumulates then travel to the next rank, and no copy still in
flight reads what a kernel writes.

:class:`RingAttentionFunction` wires forward and backward as the
reference's custom VJP: the forward saves (q, k, v, out, lse); the backward
computes delta = rowsum(dO * O) in fp32 outside the kernels, then makes one
more lap of the ring rotating (k, v, dk, dv); after the last visit dk and dv
take one final hop home.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..comms import axis_index, axis_size, ring_shift
from ..debug import check_nans

_NEG_INF = -1e30  # finite: exp(_NEG_INF - m) == 0 exactly, no inf-inf NaNs

# Kernel launches by the wrappers, per kernel. Only a launch adds to it.
LAUNCHES = {"ring_step": 0, "ring_dq": 0, "ring_dkv": 0}

HEAD_DIMS = (64, 128)  # the kernels' instantiations
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_IDS = {"ring_step": 0, "ring_dq": 1, "ring_dkv": 2}
_MAX_SMEM = 232448  # H100: dynamic shared memory one block may opt into


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(qs, kt, mode: int):
    """s = qs k^T in fp32 (qs already scaled); mode 1 hides col > row."""
    s = torch.einsum("bqd,bkd->bqk", qs, kt.float())
    if mode:
        vis = torch.ones(s.shape[-2:], dtype=torch.bool,
                         device=s.device).tril()
        s = torch.where(vis, s, torch.full((), _NEG_INF, device=s.device))
    return s


def ring_step_plain(qf, kt, vt, m, l, acc, mode: int):
    """One visiting block folded into the carries, by the explicit
    formulas: (m, l, acc) -> new (m, l, acc), fp32."""
    s = _scores(qf, kt, mode)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vt.float())
    return m_new, l_new, acc_new


def _p_ds(q, kt, vt, do, lse, delta, mode, sm_scale):
    """(p, ds) of one visit, recomputed from (q, k, lse)."""
    p = torch.exp(_scores(q.float() * sm_scale, kt, mode) - lse)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), vt.float())
    return p, p * (dp - delta)


def ring_dq_plain(q, kt, vt, do, lse, delta, dq, mode: int,
                  sm_scale: float):
    """dq + scale * ds K, fp32."""
    _, ds = _p_ds(q, kt, vt, do, lse, delta, mode, sm_scale)
    return dq + sm_scale * torch.einsum("bqk,bkd->bqd", ds, kt.float())


def ring_dkv_plain(q, kt, vt, do, lse, delta, dk, dv, mode: int,
                   sm_scale: float):
    """(dk + scale * ds^T Q, dv + p^T dO), fp32."""
    p, ds = _p_ds(q, kt, vt, do, lse, delta, mode, sm_scale)
    dk_new = dk + sm_scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv_new = dv + torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk_new, dv_new


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(kernel: str, spec: dict, mode: int) -> None:
    """``spec``: name -> (tensor, dtype, shape) the kernel takes."""
    first = next(iter(spec.values()))[0]
    for name, (t, dtype, shape) in spec.items():
        if t.device != first.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, "
                             f"{next(iter(spec))} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} "
                             f"{tuple(shape)}")
    if first.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {first.device}")
    if mode not in (0, 1):
        raise ValueError(f"{kernel}: mode {mode} not in (0, 1)")


def _kv_dtype(kernel: str, kt):
    if kt.dtype not in _DTYPE_CODES:
        raise TypeError(f"{kernel} kernel: dtype {kt.dtype} not in "
                        "(float32, bfloat16)")
    return kt.dtype


def _shape(kernel: str, t):
    bh, L, D = t.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head_dim {D} not in {HEAD_DIMS} "
                         "(the kernel's instantiations)")
    if bh >= 2**31 or -(-L // 64) > 65535:
        raise ValueError(f"{kernel} kernel: grid (bh={bh}, L={L}) exceeds "
                         "the launch limits")
    return bh, L, D


def _lib(kernel: str, head_dim: int):
    from ._build import load

    lib = _bind(load("ring_attention"))
    smem = lib.ddl_ring_smem_bytes(_KERNEL_IDS[kernel], head_dim)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(f"{kernel} kernel: head_dim {head_dim} needs {smem} "
                         f"B of shared memory, over {_MAX_SMEM}")
    return lib


def _launched(lib, kernel: str, err: int, *outputs) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{lib.ddl_cuda_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES[kernel] += 1
    check_nans(kernel, *outputs)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ring_step(qf, kt, vt, m, l, acc, mode: int):
    """Fold the visiting block (kt, vt) [bh, L, D] into the carries of the
    pre-scaled fp32 queries qf [bh, L, D]: m, l [bh, L, 1] and acc
    [bh, L, D], fp32 -> new (m, l, acc)."""
    if qf.device.type == "cpu":
        return ring_step_plain(qf, kt, vt, m, l, acc, mode)
    bh, L, D = _shape("ring_step", qf)
    T, f32 = _kv_dtype("ring_step", kt), torch.float32
    _check("ring_step", {
        "qf": (qf, f32, (bh, L, D)), "kt": (kt, T, (bh, L, D)),
        "vt": (vt, T, (bh, L, D)), "m": (m, f32, (bh, L, 1)),
        "l": (l, f32, (bh, L, 1)), "acc": (acc, f32, (bh, L, D))}, mode)
    lib = _lib("ring_step", D)
    m_o, l_o, acc_o = (torch.empty_like(x) for x in (m, l, acc))
    err = lib.ddl_ring_step(
        qf.data_ptr(), kt.data_ptr(), vt.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), m_o.data_ptr(), l_o.data_ptr(),
        acc_o.data_ptr(), bh, L, D, int(mode), _DTYPE_CODES[T], _stream(qf))
    _launched(lib, "ring_step", err, m_o, l_o, acc_o)
    return m_o, l_o, acc_o


def _bwd_spec(q, kt, vt, do, lse, delta, kernel):
    bh, L, D = _shape(kernel, q)
    T, f32 = _kv_dtype(kernel, q), torch.float32
    return bh, L, D, T, {
        "q": (q, T, (bh, L, D)), "kt": (kt, T, (bh, L, D)),
        "vt": (vt, T, (bh, L, D)), "do": (do, T, (bh, L, D)),
        "lse": (lse, f32, (bh, L, 1)), "delta": (delta, f32, (bh, L, 1))}


def ring_dq(q, kt, vt, do, lse, delta, dq, mode: int, sm_scale: float):
    """dq [bh, L, D] fp32 plus the visiting block's contribution. q, kt,
    vt, dO in one type (unscaled q); lse, delta [bh, L, 1] fp32."""
    if q.device.type == "cpu":
        return ring_dq_plain(q, kt, vt, do, lse, delta, dq, mode, sm_scale)
    bh, L, D, T, spec = _bwd_spec(q, kt, vt, do, lse, delta, "ring_dq")
    spec["dq"] = (dq, torch.float32, (bh, L, D))
    _check("ring_dq", spec, mode)
    lib = _lib("ring_dq", D)
    dq_o = torch.empty_like(dq)
    err = lib.ddl_ring_dq(
        q.data_ptr(), kt.data_ptr(), vt.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dq_o.data_ptr(),
        bh, L, D, int(mode), float(sm_scale), _DTYPE_CODES[T], _stream(q))
    _launched(lib, "ring_dq", err, dq_o)
    return dq_o


def ring_dkv(q, kt, vt, do, lse, delta, dk, dv, mode: int,
             sm_scale: float):
    """(dk, dv) [bh, L, D] fp32, the visiting block's, plus this rank's
    queries' contribution."""
    if q.device.type == "cpu":
        return ring_dkv_plain(q, kt, vt, do, lse, delta, dk, dv, mode,
                              sm_scale)
    bh, L, D, T, spec = _bwd_spec(q, kt, vt, do, lse, delta, "ring_dkv")
    spec["dk"] = (dk, torch.float32, (bh, L, D))
    spec["dv"] = (dv, torch.float32, (bh, L, D))
    _check("ring_dkv", spec, mode)
    lib = _lib("ring_dkv", D)
    dk_o, dv_o = torch.empty_like(dk), torch.empty_like(dv)
    err = lib.ddl_ring_dkv(
        q.data_ptr(), kt.data_ptr(), vt.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dk_o.data_ptr(), dv_o.data_ptr(), bh, L, D, int(mode),
        float(sm_scale), _DTYPE_CODES[T], _stream(q))
    _launched(lib, "ring_dkv", err, dk_o, dv_o)
    return dk_o, dv_o


def _bind(lib):
    """Declare the C signatures once per loaded library (ctypes would pass
    a Python int pointer as a 32-bit int without them)."""
    if getattr(lib, "_ddl_bound", False):
        return lib
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ddl_ring_step.argtypes = [vp] * 9 + [i32] * 5 + [vp]
    lib.ddl_ring_dq.argtypes = [vp] * 8 + [i32] * 4 + [f32, i32, vp]
    lib.ddl_ring_dkv.argtypes = [vp] * 10 + [i32] * 4 + [f32, i32, vp]
    for fn in (lib.ddl_ring_step, lib.ddl_ring_dq, lib.ddl_ring_dkv):
        fn.restype = i32
    lib.ddl_ring_smem_bytes.argtypes = [i32, i32]
    lib.ddl_ring_smem_bytes.restype = ctypes.c_longlong
    lib.ddl_cuda_error_string.argtypes = [i32]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    lib._ddl_bound = True
    return lib


# ---------------------------------------------------------------------------
# the per-rank ring, autograd and the public API
# ---------------------------------------------------------------------------


def _visits(idx: int, cp: int, causal: bool):
    """(t, mode or None) per visit: mode 1 on the diagonal, 0 for a fully
    visible block, None for a hidden one (no launch)."""
    for t in range(cp):
        src = (idx + t) % cp
        if not causal:
            yield t, 0
        else:
            yield t, (1 if src == idx else 0) if src <= idx else None


def _ring_fwd(q, k, v, mesh, axis_name, causal):
    """Per-rank forward over folded [bh, L, D] blocks: (out in q's dtype,
    lse [bh, L, 1] fp32)."""
    cp, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    bh, L, d = q.shape
    qf = q.float() * (1.0 / math.sqrt(d))
    m = torch.full((bh, L, 1), _NEG_INF, device=q.device)
    l = torch.zeros((bh, L, 1), device=q.device)
    acc = torch.zeros((bh, L, d), device=q.device)
    kt, vt = k, v
    for t, mode in _visits(idx, cp, causal):
        if mode is not None:
            m, l, acc = ring_step(qf, kt, vt, m, l, acc, mode)
        if t < cp - 1:  # the last block's rotation would feed nothing
            kt, vt = ring_shift((kt, vt), mesh, axis_name, shift=-1)
    lc = torch.clamp(l, min=1e-30)
    return (acc / lc).to(q.dtype), m + torch.log(lc)


def _ring_bwd(q, k, v, out, lse, do, mesh, axis_name, causal):
    """Per-rank backward: one more lap rotating (k, v, dk, dv); dk and dv
    end with one hop home. Returns (dq, dk, dv) in the inputs' dtypes."""
    cp, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    kt, vt = k, v
    for t, mode in _visits(idx, cp, causal):
        if mode is not None:
            dq = ring_dq(q, kt, vt, do, lse, delta, dq, mode, scale)
            dk, dv = ring_dkv(q, kt, vt, do, lse, delta, dk, dv, mode, scale)
        if t < cp - 1:
            kt, vt, dk, dv = ring_shift((kt, vt, dk, dv), mesh, axis_name,
                                        shift=-1)
    dk, dv = ring_shift((dk, dv), mesh, axis_name, shift=-1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """out = ring(q, k, v) over this rank's folded [bh, L, D] blocks,
    differentiable in q, k, v through the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name: str, causal: bool):
        out, lse = _ring_fwd(q, k, v, mesh, axis_name, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (mesh, axis_name, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, do.contiguous(), *ctx.opts)
        return dq, dk, dv, None, None, None


def ring_attention_pallas(q, k, v, mesh, *, causal: bool = True,
                          axis_name: str = "cp"):
    """Fused-kernel ring attention on this rank's ``[batch, seq_local,
    heads, head_dim]`` blocks, a drop-in for
    :func:`ops.ring_attention.ring_attention`. Local lengths that are no
    multiple of the kernels' 64-row tiles need no padding: the kernels hide
    the ragged edge themselves."""
    from ..parallel.sp_ring import check_ring_shapes

    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    b, lq, h, d = q.shape
    check_ring_shapes(lq * axis_size(mesh, axis_name),
                      axis_size(mesh, axis_name))

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, lq, d).contiguous()

    out = RingAttentionFunction.apply(fold(q), fold(k), fold(v), mesh,
                                      axis_name, causal)
    return out.reshape(b, h, lq, d).permute(0, 2, 1, 3)
