"""Paged-attention decode: the serving engine's hot read path.

The decode loop (``serving/engine.py``) runs ONE token per row against the
block-pooled KV cache. :func:`paged_attention` reads the pool in place
through the page table, with no gathered copy: on a CUDA tensor it
launches the hand-written Hopper kernels of ``csrc/paged_attention.cu``
(fp pools, and int8 pools whose per-(slot, head) scales are applied on
load): a split kernel, in which each block attends one split of a row's
columns and writes its partial softmax to fp32 scratch allocated here, and
a merge of the splits, both from one C call. On a CPU tensor it runs
:func:`paged_attention_plain`, the same math in plain torch, which is also
what the CPU tests and ``chip_smoke.py`` hold the kernel against. There is
no fallback: a CUDA input the kernel does not take raises.

Semantics: the caller has already scattered this step's k/v at position
``seq_lens[b]``, and row b attends columns ``0 .. seq_lens[b]`` inclusive.
Idle rows (cursor 0, page table parked on the null block) attend exactly
position 0 of block 0; the engine discards their output.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..debug import check_nans

_NEG_INF = -1e30  # finite: exp(_NEG_INF - m) == 0 exactly, no inf-inf NaNs

# Kernel launches by the wrapper, per kernel — the count a run reads to show
# that its decode steps went through the kernels. Only a launch adds to it.
LAUNCHES = {"paged_decode": 0, "paged_decode_q8": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The head dims the kernel is built for: those of the JAX package's model
# sizes (16 tiny; 64 GPT-2, BERT, ViT, Llama 300m/1b; 128 Llama 7b).
HEAD_DIMS = (16, 64, 128)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_scales(pool_k, scale_k, scale_v) -> bool:
    """Validate the quantized-pool operand set: int8 pools require BOTH
    scale pools with the pool's (num_blocks, block_size, kv_heads) layout;
    fp pools must not carry scales. Returns True when the pool is
    quantized."""
    num_blocks, block_size, kv_heads, _ = pool_k.shape
    quantized = pool_k.dtype == torch.int8
    if not quantized:
        if scale_k is not None or scale_v is not None:
            raise ValueError(
                f"scale_k/scale_v passed with a non-int8 pool "
                f"(dtype {pool_k.dtype}) — scales only pair with "
                "kv_quant='int8' pools"
            )
        return False
    want = (num_blocks, block_size, kv_heads)
    for name, s in (("scale_k", scale_k), ("scale_v", scale_v)):
        if s is None:
            raise ValueError(
                f"int8 pool without {name}: quantized pools need one f32 "
                f"scale per (page slot, kv head) — shape {want}"
            )
        if tuple(s.shape) != want:
            raise ValueError(
                f"{name} shape {tuple(s.shape)} must be "
                f"[num_blocks, block_size, kv_heads] = {want}"
            )
    return True


def _check_shapes(q, pool_k, pool_v, page_table, seq_lens, num_rep):
    B, H, D = q.shape
    _, _, kv_heads, Dk = pool_k.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError(
            f"pool_k/pool_v shapes differ: {tuple(pool_k.shape)} "
            f"{tuple(pool_v.shape)}"
        )
    if Dk != D or H != kv_heads * num_rep:
        raise ValueError(
            f"q [B,H,D]={tuple(q.shape)} incompatible with pool "
            f"[NB,bs,kv_heads,D]={tuple(pool_k.shape)} at num_rep={num_rep}"
        )
    num_pages = page_table.shape[-1]
    if tuple(page_table.shape) != (B, num_pages) or tuple(
        seq_lens.shape
    ) != (B,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} must be [B={B}, pages] / [B={B}]"
        )


def paged_attention(q, pool_k, pool_v, page_table, seq_lens, *,
                    scale_k=None, scale_v=None, num_rep: int = 1,
                    sm_scale: float | None = None):
    """One decode step of attention against the paged KV pool, in place.

    - ``q``: [B, H, D] — one query token per row, heads group-major over kv
      groups (H = kv_heads * num_rep);
    - ``pool_k`` / ``pool_v``: [num_blocks, block_size, kv_heads, D];
    - ``page_table``: [B, pages] int32 — row b's logical page j lives in
      pool block ``page_table[b, j]``; every entry must be a valid block id
      (the engine range-checks every table on the host);
    - ``seq_lens``: [B] int32 — the row's cursor BEFORE this token: row b
      attends columns ``0 .. seq_lens[b]``;
    - ``scale_k`` / ``scale_v``: [num_blocks, block_size, kv_heads] f32,
      required iff the pool is int8.

    Returns [B, H, D] in q's dtype.
    """
    _check_shapes(q, pool_k, pool_v, page_table, seq_lens, num_rep)
    quantized = _check_scales(pool_k, scale_k, scale_v)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, page_table, seq_lens, scale_k=scale_k,
            scale_v=scale_v, num_rep=num_rep, sm_scale=sm_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch(q, pool_k, pool_v, page_table, seq_lens, scale_k, scale_v,
                   num_rep, float(sm_scale), quantized)


def check_kernel_operands(q, pool_k, pool_v, page_table) -> None:
    """What the CUDA kernel takes beyond the shapes, checked before any
    launch: a head dim it was built for, and the pools on 16-byte
    boundaries (``cp.async`` copies them 16 bytes at a time). The page
    table, read 4 bytes at a time, is held to the same boundary: one rule
    for every pointer the C entry takes, which the caching allocator and
    the engine's own tables always meet."""
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel: head_dim {D} is not built; "
            f"csrc/paged_attention.cu instantiates {HEAD_DIMS}"
        )
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("page_table", page_table)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"paged_attention kernel: {name} at {t.data_ptr():#x} is not "
                "16-byte aligned"
            )


def _launch(q, pool_k, pool_v, page_table, seq_lens, scale_k, scale_v,
            num_rep, sm_scale, quantized):
    operands = {"q": q, "pool_k": pool_k, "pool_v": pool_v,
                "page_table": page_table, "seq_lens": seq_lens}
    if quantized:
        operands.update(scale_k=scale_k, scale_v=scale_v)
    for name, t in operands.items():
        if t.device != q.device:
            raise ValueError(
                f"paged_attention: {name} on {t.device}, q on {q.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention kernel: q dtype {q.dtype} "
                        "not in (float32, bfloat16)")
    if pool_k.dtype not in _DTYPE_CODES or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"paged_attention kernel: pool dtypes "
                        f"{pool_k.dtype}/{pool_v.dtype} not float32, "
                        "bfloat16 or int8 (both alike)")
    for name in ("page_table", "seq_lens"):
        if operands[name].dtype != torch.int32:
            raise TypeError(f"paged_attention kernel: {name} must be int32")
    if quantized and (scale_k.dtype != torch.float32
                      or scale_v.dtype != torch.float32):
        raise TypeError("paged_attention kernel: scales must be float32")
    check_kernel_operands(q, pool_k, pool_v, page_table)
    B, H, D = q.shape
    _, block_size, kv_heads, _ = pool_k.shape
    num_pages = page_table.shape[-1]
    from ._build import load

    lib = _bind(load("paged_attention"))
    n_splits = -(-num_pages * block_size // lib.ddl_paged_attention_split())
    if B * H >= 2**31 or n_splits > 65535:
        raise ValueError(
            f"paged_attention kernel: grid (B*H={B * H}, splits={n_splits}) "
            "exceeds the launch limits (2**31 - 1, 65535)"
        )
    out = torch.empty_like(q)
    # Each split's unnormalised o and its (m, l); the merge reads only the
    # live splits, so nothing needs zeroing.
    o_part = torch.empty(B, H, n_splits, D, dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty(2, B, H, n_splits, dtype=torch.float32,
                          device=q.device)
    err = lib.ddl_paged_attention_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        scale_k.data_ptr() if quantized else None,
        scale_v.data_ptr() if quantized else None,
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), ml_part[0].data_ptr(), ml_part[1].data_ptr(),
        B, H, D, block_size, kv_heads, num_pages, num_rep, n_splits,
        sm_scale, _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            f"{lib.ddl_cuda_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES["paged_decode_q8" if quantized else "paged_decode"] += 1
    check_nans("paged_decode_q8" if quantized else "paged_decode", out)
    return out


def _bind(lib):
    """Declare the C signatures once per loaded library (ctypes would pass
    a Python int pointer as a 32-bit int without them)."""
    if getattr(lib, "_ddl_bound", False):
        return lib
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.ddl_paged_attention_decode
    fn.argtypes = [vp] * 11 + [i32] * 8 + [ctypes.c_float, i32, i32, vp]
    fn.restype = i32
    lib.ddl_paged_attention_split.argtypes = []
    lib.ddl_paged_attention_split.restype = i32
    lib.ddl_cuda_error_string.argtypes = [i32]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    lib._ddl_bound = True
    return lib


def paged_attention_plain(q, pool_k, pool_v, page_table, seq_lens, *,
                          scale_k=None, scale_v=None, num_rep: int = 1,
                          sm_scale: float | None = None):
    """Plain torch version of :func:`paged_attention`: the engine's gather
    lowering at the kernel's [B, H, D] signature (gather pages -> dequant
    against the gathered scales -> mask ``col <= cursor`` -> fp32
    softmax), the math of the JAX package's ``paged_attention_reference``.
    """
    _check_shapes(q, pool_k, pool_v, page_table, seq_lens, num_rep)
    quantized = _check_scales(pool_k, scale_k, scale_v)
    B, H, D = q.shape
    _, bs, kv_heads, _ = pool_k.shape
    pages = page_table.shape[-1]
    tbl = page_table.long()
    ck = pool_k[tbl].to(torch.float32).reshape(B, pages * bs, kv_heads, D)
    cv = pool_v[tbl].to(torch.float32).reshape(B, pages * bs, kv_heads, D)
    if quantized:
        ck = ck * scale_k[tbl].reshape(B, pages * bs, kv_heads, 1)
        cv = cv * scale_v[tbl].reshape(B, pages * bs, kv_heads, 1)
    qg = q.reshape(B, kv_heads, num_rep, D).to(torch.float32)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, ck)
    s = s / math.sqrt(D) if sm_scale is None else s * sm_scale
    cols = torch.arange(pages * bs, device=q.device)
    visible = cols[None, None, None, :] <= seq_lens.long()[:, None, None, None]
    s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, cv)
    return out.reshape(B, H, D).to(q.dtype)
