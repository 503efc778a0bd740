"""Transformer backbone of the port: the block and stack GPT-2 (causal,
pre-LN, tanh GELU), ViT (pre-LN, exact GELU) and BERT (post-LN, exact GELU,
key-padding masks) share, with per-block remat (``models/remat.py``), the
attention core, and the two KV caches a forward decodes against: the
contiguous per-sequence cache of ``generate`` (:class:`KVCache`) and the
paged cache of the serving engine (:class:`PagedKVCache`).

Parameters keep the JAX package's names and layouts (attention projections
``kernel [E, H, D]``, out projection ``[H, D, E]``, LayerNorm ``scale`` /
``bias``), so a state_dict key is the flattened JAX parameter path
(``weights.from_jax_params``). Parameters are stored in fp32 and cast to the
compute ``dtype`` at use, as flax's ``Dense(dtype=...)`` does; attention
scores and the softmax run in fp32 whatever the compute dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..comms_quant import block_quantize
from ..debug import checks_on
from ..parallel.fsdp import full_param, reshard_after_forward
from .remat import check_remat, checkpoint_block

_NEG_INF = -1e30

ATTN_IMPLS = ("xla", "flash", "ring", "ring_pallas", "ulysses",
              "ulysses_flash")
# A decode cache on a model cut over ranks: the reference decodes on one
# program, dropping the mesh and the kernel options before it does (its
# ``cli generate`` and ``cli serve``), as the port's one-rank restore does.
SHARDED_DECODE = ("decode of a model cut over tp, fsdp or ep: the reference "
                  "decodes on one program with the mesh dropped (cli generate "
                  "and cli serve); restore the checkpoint on one rank")


@dataclasses.dataclass
class KVCache:
    """The contiguous decode cache of ``generate`` (the reference's
    ``'cache'`` collection of ``decode_attention``).

    - ``layers``: one dict per layer, ``cached_key``/``cached_value``
      ``[B, total, kv_heads, D]`` in the compute dtype, holding k and v
      BEFORE the GQA repeat;
    - ``cache_index``: the cursor, the number of positions written. A
      forward writes its L tokens at ``cache_index .. cache_index + L - 1``;
      ``generate.prefill`` advances it by L after the forward;
    - ``start``: [B] int, row b's number of left pads. Columns below it are
      never visible, and positions count from it (row b's first real token
      sits at position 0).
    """

    layers: list
    start: torch.Tensor
    cache_index: int = 0

    @classmethod
    def empty(cls, num_layers: int, batch: int, total: int, kv_heads: int,
              head_dim: int, dtype, device, start=None) -> KVCache:
        """Zeroed caches of ``total`` positions, pad-free unless
        ``start`` ([B] left-pad counts) is given."""
        def zeros():
            return torch.zeros(batch, total, kv_heads, head_dim, dtype=dtype,
                               device=device)

        if start is None:
            start = torch.zeros(batch, dtype=torch.int64, device=device)
        return cls(layers=[{"cached_key": zeros(), "cached_value": zeros()}
                           for _ in range(num_layers)],
                   start=torch.as_tensor(start, device=device).long())

    def positions(self, length: int) -> torch.Tensor:
        """[B, length] positions of this call's tokens: ``max(cache_index +
        t - start[b], 0)``."""
        steps = torch.arange(length, device=self.start.device)
        return torch.clamp(self.cache_index + steps[None, :]
                           - self.start[:, None], min=0)


@dataclasses.dataclass
class PagedKVCache:
    """The paged KV state one forward reads and writes.

    - ``pools``: one dict per layer (:func:`paged_pool_specs`): the KV
      blocks ``pool_key``/``pool_value`` ``[num_blocks, block_size,
      kv_heads, D]`` (and ``pool_key_scale``/``pool_value_scale``
      ``[num_blocks, block_size, kv_heads]`` under int8), shared by every
      batch size — the B=1 prefill and the B=slots decode write the SAME
      tensors, in place;
    - ``page_table``: [B, pages] int32 — row b's logical block j lives in
      pool block ``page_table[b, j]``;
    - ``seq_lens``: [B] int32 — tokens already cached per row; this call's
      L tokens occupy positions ``seq_lens[b] .. seq_lens[b] + L - 1``. The
      caller owns the cursor: a forward does not advance it;
    - ``kernel``: the decode read path, 'reference' (gather) or 'pallas'
      (the paged-decode kernel; the name is the reference schema's).
    """

    pools: list
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    kernel: str = "reference"


def paged_pool_specs(kv_heads: int, head_dim: int, dtype, num_blocks: int,
                     block_size: int, kv_quant: str = "off") -> dict:
    """One layer's pool tensors as ``name -> (shape, dtype)``: the model
    dtype, or int8 plus f32 scales with ``kv_quant='int8'``."""
    if kv_quant not in ("off", "int8"):
        raise ValueError(f"kv_quant must be 'off' or 'int8', got {kv_quant!r}")
    shape = (num_blocks, block_size, kv_heads, head_dim)
    if kv_quant == "off":
        return {"pool_key": (shape, dtype), "pool_value": (shape, dtype)}
    return {
        "pool_key": (shape, torch.int8),
        "pool_value": (shape, torch.int8),
        "pool_key_scale": (shape[:3], torch.float32),
        "pool_value_scale": (shape[:3], torch.float32),
    }


def _promoted_einsum(eq: str, a: torch.Tensor, b: torch.Tensor):
    """``einsum`` with jnp's type promotion (torch's einsum wants equal
    dtypes): bf16 probs against an f32 dequantized cache compute in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def act_cuts(mesh, sequence_parallel: bool = False,
             seq_len: int | None = None) -> tuple:
    """The cuts of an activation ``[batch, seq, ...]`` over ``mesh`` (see
    :func:`_global_rand`): the batch over (dp, fsdp), the sequence over cp
    (a rank's contiguous block) and, under sequence parallelism, that block
    over tp (``parallel.tp.seq_shard``: ``seq_len``, the cp block's length,
    where tp does not divide it, the last shard padded)."""
    from ..mesh import BATCH_AXES

    cp = 1 if mesh is None else mesh.shape["cp"]
    seq = ("cp", "tp") if sequence_parallel else ("cp",)
    return ((BATCH_AXES, None),
            (seq, None if seq_len is None else seq_len * cp))


def head_cuts(heads: tuple = ("tp",)) -> tuple:
    """The cuts of attention probabilities ``[batch, heads, q, k]``: the
    batch over (dp, fsdp), the heads over ``heads`` (a tp rank's block;
    under Ulysses its block of (tp, cp), JAX's order)."""
    from ..mesh import BATCH_AXES

    return ((BATCH_AXES, None), (heads, None))


def _block(mesh, axes: tuple, local: int, whole: int | None) -> tuple:
    """(whole length, offset, valid rows) of this rank's block of a
    dimension cut over ``axes`` (outer first) into ``local`` rows: each
    axis cuts what the previous left into blocks of ``ceil(n / k)``, the
    rows past the end padding (``whole``: the dimension's length, default
    ``local`` times the axes' sizes)."""
    sizes = [mesh.shape[a] for a in axes]
    whole = local * math.prod(sizes) if whole is None else whole
    offset, valid = 0, whole
    for a, k in zip(axes, sizes):
        n = -(-valid // k)
        lo = mesh.coords[a] * n
        offset, valid = offset + lo, max(0, min(n, valid - lo))
    return whole, offset, valid


def _global_rand(shape, generator, device, mesh, cuts=()):
    """Uniforms for this rank's block of the whole tensor that one process
    would hold: the draw is made at the whole shape and sliced, so a mask
    does not depend on how the ranks cut the tensor, as JAX's masks over
    global arrays do not, and every mesh draws the one-rank port's masks
    from the same generator. ``cuts``: per leading dimension, (mesh axes
    that cut it, outer first; its whole length or None), as
    :func:`act_cuts` and :func:`head_cuts` give them. Rows past a
    dimension's end (an uneven sequence-parallel shard's padding) draw 0.

    Each rank draws the whole tensor, so it spends the one-rank draw's time
    and memory on every dropout site: a counter-based draw of its block
    alone (Philox keyed by the element's whole index) would not, and is
    left for later (ROADMAP A15.q)."""
    if mesh is None or all(mesh.shape[a] == 1 for axes, _ in cuts
                           for a in axes):
        return torch.rand(shape, generator=generator, device=device)
    full_shape, index = list(shape), [slice(None)] * len(shape)
    for d, (axes, whole) in enumerate(cuts):
        full_shape[d], lo, valid = _block(mesh, axes, shape[d], whole)
        index[d] = slice(lo, lo + valid)
    got = torch.rand(full_shape, generator=generator, device=device)[
        tuple(index)]
    if got.shape == tuple(shape):
        return got
    out = got.new_zeros(shape)
    out[tuple(slice(0, n) for n in got.shape)] = got
    return out


def dropout(x, rate: float, generator, mesh=None, cuts=()):
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``. Deterministic (the
    identity) without a generator or at rate 0. On a ``mesh`` the mask is
    this rank's block of the mask of the whole tensor, ``x`` cut as
    ``cuts`` says (:func:`_global_rand`)."""
    if not rate or generator is None:
        return x
    keep = 1.0 - rate
    mask = _global_rand(x.shape, generator, x.device, mesh, cuts) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def attention_core(q, k, v, *, causal: bool, dtype, impl: str = "xla",
                   mask=None, kv_valid=None, dropout=None, mesh=None):
    """Post-projection attention dispatch, the reference's one place where
    the xla, the fused flash and the ring cores are selected. q/k/v:
    [batch, seq, heads, head_dim] with equal head counts (this rank's
    sequence block under the ring cores).

    - ``impl='xla'``: einsum + fp32 softmax. ``mask``: [batch, k_len]
      (True = attend) or broadcastable to the [batch, heads, q_len, k_len]
      scores; ``dropout`` (a callable on the probs) applies here only.
    - ``impl='flash'``: ``ops.flash_attention`` (the hand-written kernels on
      the GPU), with ``kv_valid`` [batch] the per-sequence key-padding
      limit.
    - ``impl='ring'`` / ``'ring_pallas'``: ring attention over the ``cp``
      axis of ``mesh`` (``parallel.sp_ring``), which they require.
    """
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, kv_valid_lens=kv_valid)
    if impl in ("ring", "ring_pallas"):
        if mesh is None:
            raise ValueError(f"attn_impl={impl!r} requires mesh")
        from ..parallel.sp_ring import ring_attention_fn

        return ring_attention_fn(impl)(q, k, v, mesh, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attn_impl {impl!r}")
    head_dim = q.shape[-1]
    scores = _promoted_einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(head_dim)
    neg = torch.full((), _NEG_INF, dtype=scores.dtype, device=scores.device)
    if causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        tril = torch.ones(q_len, k_len, dtype=torch.bool,
                          device=scores.device).tril()
        scores = torch.where(tril[None, None], scores, neg)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        scores = torch.where(mask.bool(), scores, neg)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    if dropout is not None:
        probs = dropout(probs)
    return _promoted_einsum("bhqk,bkhd->bqhd", probs, v)


def _cache_attend(q, ck, cv, visible, num_rep: int, dtype):
    """Attend q [B, L, H, D] against a full cached k/v [B, K, kv_heads, D]
    under a [B, L, K] visibility mask. ``num_rep > 1`` (GQA) contracts each
    query-head group against the un-repeated cache (query head g*rep+r
    reads kv group g)."""
    B, L, H, D = q.shape
    if num_rep > 1:
        kv_heads = ck.shape[2]
        qg = q.reshape(B, L, kv_heads, num_rep, D)
        scores = _promoted_einsum("bqgrd,bkgd->bgrqk", qg, ck).float()
        scores = scores / math.sqrt(D)
        scores = torch.where(visible[:, None, None, :, :], scores,
                             torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(dtype)
        out = _promoted_einsum("bgrqk,bkgd->bqgrd", probs, cv)
        return out.reshape(B, L, H, D)
    return attention_core(
        q, ck, cv, causal=False, dtype=dtype, mask=visible[:, None, :, :],
    )


def decode_attention(q, k, v, *, dtype, cache: KVCache, layer: int,
                     num_rep: int = 1):
    """Decode attention against the contiguous :class:`KVCache` (the
    reference's ``decode_attention``): this call's k/v ([B, L, kv_heads,
    D], before the GQA repeat) are written at the cursor, then query t
    (absolute position ``cache_index + t``) attends the written columns up
    to its own, except row b's pad columns below ``start[b]``. L == 1 is
    one decode step, L > 1 a bulk prefill. Plain torch, as the reference
    leaves it to XLA; the columns past the cursor, all masked in the
    reference, are not read."""
    ck = cache.layers[layer]["cached_key"]
    cv = cache.layers[layer]["cached_value"]
    i, L = cache.cache_index, k.shape[1]
    if i + L > ck.shape[1]:
        raise ValueError(f"KV cache of {ck.shape[1]} positions is full: "
                         f"cursor {i} + {L} tokens")
    ck[:, i:i + L] = k
    cv[:, i:i + L] = v
    cols = torch.arange(i + L, device=k.device)
    qpos = i + torch.arange(L, device=k.device)
    visible = ((cols[None, None, :] <= qpos[None, :, None])
               & (cols[None, None, :] >= cache.start[:, None, None]))
    return _cache_attend(q, ck[:, :i + L], cv[:, :i + L], visible, num_rep,
                         dtype)


def paged_decode_attention(q, k, v, *, dtype, pools: dict,
                           page_table: torch.Tensor, seq_lens: torch.Tensor,
                           num_rep: int = 1, kernel: str = "reference"):
    """Decode/prefill attention against the PAGED KV cache (serving).

    q: [B, L, H, D]; k/v: [B, L, kv_heads, D]; ``pools`` is this layer's
    dict of pool tensors (:class:`PagedKVCache`). This call's k/v are
    scattered at positions ``seq_lens[b] + i`` first; then query i of row b
    attends columns ``0 .. seq_lens[b] + i``. L == 1 is one decode step,
    L > 1 bulk prefill. Idle rows (cursor 0, table on the null block 0)
    write to and read position 0 of block 0; their output is discarded.

    ``kernel='pallas'`` reads the pool in place through
    ``ops.paged_attention`` for decode steps (L == 1) only; bulk prefill and
    ``kernel='reference'`` gather each row's pages into a contiguous
    [B, pages*bs] view and run :func:`_cache_attend`.

    An int8 pool (``pool_key.dtype == int8``) quantizes each written
    (token, head) D-vector with ``comms_quant.block_quantize`` at write
    time; its scale lands at the same flat index, and reads dequantize.
    """
    if kernel not in ("reference", "pallas"):
        raise ValueError(
            f"paged kernel must be 'reference' or 'pallas', got {kernel!r}"
        )
    pk, pv = pools["pool_key"], pools["pool_value"]
    sk, sv = pools.get("pool_key_scale"), pools.get("pool_value_scale")
    quantized = pk.dtype == torch.int8
    num_blocks, bs, Hkv, D = pk.shape
    B, L = k.shape[:2]
    pages = page_table.shape[1]
    bad = None
    if checks_on():
        # The out-of-bounds tripwire (``train.debug_checks``): whether an
        # entry is in range is data-dependent, so a row whose table holds
        # one outside the pool is pointed at the null block (neither the
        # pool writes nor the kernel read outside the pool) and its output
        # poisoned to NaN below.
        bad = ((page_table < 0) | (page_table >= num_blocks)).any(dim=1)
        page_table = torch.where(bad[:, None], torch.zeros_like(page_table),
                                 page_table)
    tbl = page_table.long()
    pos = seq_lens.long()[:, None] + torch.arange(L, device=k.device)[None, :]
    blk = torch.gather(tbl, 1, pos // bs)
    flat = (blk * bs + pos % bs).reshape(-1)
    k_w, v_w = k.reshape(B * L, Hkv, D), v.reshape(B * L, Hkv, D)
    if quantized:
        qk, k_scale = block_quantize(k.float().reshape(-1), D)
        qv, v_scale = block_quantize(v.float().reshape(-1), D)
        k_w, v_w = qk.reshape(B * L, Hkv, D), qv.reshape(B * L, Hkv, D)
        sk.view(num_blocks * bs, Hkv).index_copy_(
            0, flat, k_scale.reshape(B * L, Hkv))
        sv.view(num_blocks * bs, Hkv).index_copy_(
            0, flat, v_scale.reshape(B * L, Hkv))
    # In place: the pool tensors are the engine's, shared across calls (the
    # JAX package donates the cache buffers for the same effect). Duplicate
    # indices only ever hit the null block (idle rows, prefill pad).
    pk.view(num_blocks * bs, Hkv, D).index_copy_(0, flat, k_w)
    pv.view(num_blocks * bs, Hkv, D).index_copy_(0, flat, v_w)
    if kernel == "pallas" and L == 1:
        from ..ops.paged_attention import paged_attention

        out = paged_attention(
            q[:, 0].contiguous(), pk, pv, page_table, seq_lens,
            num_rep=num_rep, scale_k=sk, scale_v=sv,
        )[:, None]
    else:
        ck = pk[tbl].reshape(B, pages * bs, Hkv, D)
        cv = pv[tbl].reshape(B, pages * bs, Hkv, D)
        if quantized:
            ck = ck.float() * sk[tbl].reshape(B, pages * bs, Hkv, 1)
            cv = cv.float() * sv[tbl].reshape(B, pages * bs, Hkv, 1)
        cols = torch.arange(pages * bs, device=k.device)
        visible = cols[None, None, :] <= pos[:, :, None]  # causal per row
        out = _cache_attend(q, ck, cv, visible, num_rep, dtype)
    if bad is not None:
        out = torch.where(bad[:, None, None, None],
                          torch.full((), float("nan"), dtype=out.dtype,
                                     device=out.device), out)
    return out


class Dense(nn.Module):
    """flax ``DenseGeneral``: ``kernel`` [*in_shape, *out_shape] and
    ``bias`` [*out_shape], in fp32, cast to ``dtype`` at use. With
    ``use_bias=False`` there is no ``bias`` parameter at all, as flax
    creates none (Llama's projections)."""

    def __init__(self, in_shape, out_shape, dtype, device=None, *,
                 use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            self.in_shape + self.out_shape, device=device))
        self.bias = (nn.Parameter(torch.empty(self.out_shape, device=device))
                     if use_bias else None)

    def full_bias(self):
        """The bias in the compute dtype (gathered whole under fsdp), or
        None."""
        if self.bias is None:
            return None
        return full_param(self, "bias", self.dtype).to(self.dtype)

    def _apply_linear(self, x, bias: bool):
        n_in = len(self.in_shape)
        lead = x.shape[: x.ndim - n_in]
        w = full_param(self, "kernel", self.dtype).to(self.dtype).reshape(
            math.prod(self.in_shape), math.prod(self.out_shape))
        b = self.full_bias() if bias else None
        b = None if b is None else b.reshape(-1)
        y = F.linear(x.reshape(-1, w.shape[0]).to(self.dtype), w.t(), b)
        return y.reshape(*lead, *self.out_shape)

    def product(self, x):
        """The product with the kernel alone, no bias."""
        return self._apply_linear(x, bias=False)

    def forward(self, x):
        return self._apply_linear(x, bias=True)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=...)``: statistics and affine in fp32, the
    result cast to ``dtype``."""

    def __init__(self, features: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        scale = full_param(self, "scale").float()
        y = F.layer_norm(x.float(), scale.shape, scale,
                         full_param(self, "bias").float(), self.eps)
        return y.to(self.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention, ``causal`` or not, with
    ``query``/``key``/``value`` [E, H, D] and ``out`` [H, D, E]
    projections. With a cache it dispatches on the cache's type: a
    :class:`KVCache` runs :func:`decode_attention` on layer ``layer``'s
    cache, a :class:`PagedKVCache` :func:`paged_decode_attention` on its
    pools (both plain torch whatever ``attn_impl``, and neither takes a
    mask); without, the ``attn_impl`` core:

    - ``xla``: einsum + softmax, with attention-prob dropout in training;
    - ``flash``: the fused flash kernels (``ops/flash_attention.py``). It
      takes mask=None or a [batch, k_len] contiguous-prefix key-padding
      mask (turned into per-sequence kv limits; rows whose mask is not a
      prefix are poisoned to NaN), and no active attention-dropout;
    - ``ring`` / ``ring_pallas``: ring attention over ``mesh``'s cp axis,
      with mask=None and no active attention-dropout;
    - ``ulysses`` / ``ulysses_flash``: the xla or the flash core over the
      whole sequence and this rank's ``H / (tp * cp)`` heads, behind the
      all-to-alls over cp (``parallel.sp_ulysses``); ``ulysses`` takes the
      key-padding ``mask`` of the whole sequence (``[batch, seq]``,
      gathered over cp by the caller), ``ulysses_flash`` mask=None and no
      active attention-dropout.

    On a ``mesh`` with tp > 1 the rank holds ``num_heads / tp`` heads
    (``parallel.tp``): query/key/value are column-parallel after the
    region's entry, ``out`` row-parallel, and the core runs on the rank's
    heads; ``sequence_parallel``: ``x`` is the rank's seq shard, gathered
    at the entry (cut to ``seq_len`` positions where tp does not divide
    them) and scattered at the exit. No decode cache under tp.
    """

    def __init__(self, embed_dim, num_heads, head_dim, dtype, device=None,
                 *, causal: bool = True, attn_impl: str = "xla",
                 dropout_rate: float = 0.0, mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.causal, self.num_heads = causal, num_heads
        self.dtype, self.attn_impl = dtype, attn_impl
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self.sequence_parallel = sequence_parallel and self.tp > 1
        heads = num_heads // self.tp
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(
                (embed_dim,), (heads, head_dim), dtype, device))
        if self.tp > 1:
            from ..parallel.tp import RowParallelDense

            self.out = RowParallelDense(
                (heads, head_dim), (embed_dim,), dtype, device, mesh=mesh,
                sequence_parallel=self.sequence_parallel)
        else:
            self.out = Dense((heads, head_dim), (embed_dim,), dtype, device)

    def forward(self, x, cache: KVCache | PagedKVCache | None = None,
                layer: int = 0, *, mask=None, generator=None,
                seq_len: int | None = None):
        if self.tp > 1:
            if cache is not None:
                raise NotImplementedError(SHARDED_DECODE)
            from ..parallel.tp import enter

            x = enter(x, self.mesh, self.sequence_parallel, seq_len)
        q, k, v = self.query(x), self.key(x), self.value(x)
        if cache is not None and mask is not None:
            raise NotImplementedError(
                "decode ignores key-padding masks — pad-free prompts only "
                "(the cache visibility mask is cursor-based)"
            )
        if isinstance(cache, KVCache):
            out = decode_attention(q, k, v, dtype=self.dtype, cache=cache,
                                   layer=layer)
        elif cache is not None:
            out = paged_decode_attention(
                q, k, v, dtype=self.dtype, pools=cache.pools[layer],
                page_table=cache.page_table, seq_lens=cache.seq_lens,
                kernel=cache.kernel,
            )
        elif self.attn_impl in ("ring", "ring_pallas"):
            if mask is not None or (self.dropout_rate and generator is not None):
                raise NotImplementedError(
                    "ring attention supports mask=None and no active "
                    "attention-dropout"
                )
            out = attention_core(q, k, v, impl=self.attn_impl,
                                 causal=self.causal, dtype=self.dtype,
                                 mesh=self.mesh)
        elif self.attn_impl in ("ulysses", "ulysses_flash"):
            out = self._ulysses(q, k, v, mask, generator)
        elif self.attn_impl == "flash":
            if self.dropout_rate and generator is not None:
                raise NotImplementedError(
                    "flash attention supports no active attention-dropout"
                )
            kv_valid = not_prefix = None
            if mask is not None:
                if mask.ndim != 2:
                    raise NotImplementedError(
                        "flash attention supports key-padding masks "
                        "([batch, k_len] contiguous prefix) or mask=None"
                    )
                # Contiguous-prefix mask -> per-sequence kv limit. Whether a
                # mask IS a prefix is data-dependent, so non-prefix rows are
                # poisoned to NaN below rather than checked on the host.
                kv_valid = mask.to(torch.int32).sum(-1)
                cols = torch.arange(mask.shape[-1], device=mask.device)
                prefix = cols[None, :] < kv_valid[:, None]
                not_prefix = (mask.bool() != prefix).any(-1)
            out = attention_core(q, k, v, impl="flash", causal=self.causal,
                                 dtype=self.dtype, kv_valid=kv_valid)
            if not_prefix is not None:
                out = torch.where(not_prefix[:, None, None, None],
                                  torch.full((), float("nan"),
                                             dtype=out.dtype,
                                             device=out.device), out)
        else:
            rate, mesh = self.dropout_rate, self.mesh
            out = attention_core(
                q, k, v, causal=self.causal, dtype=self.dtype, mask=mask,
                dropout=lambda p: dropout(p, rate, generator, mesh,
                                          head_cuts()),
            )
        return self.out(out)

    def _ulysses(self, q, k, v, mask, generator):
        from ..parallel.sp_ulysses import ulysses_attention

        flash = self.attn_impl == "ulysses_flash"
        active = bool(self.dropout_rate and generator is not None)
        if flash and (mask is not None or active):
            raise NotImplementedError(
                "ulysses_flash supports mask=None and no active "
                "attention-dropout")
        rate, mesh = self.dropout_rate, self.mesh
        # After the flip a rank holds the whole sequence's probabilities on
        # its block of the heads over (tp, cp).
        return ulysses_attention(
            q, k, v, flash=flash, causal=self.causal, dtype=self.dtype,
            mesh=mesh, num_heads=self.num_heads,
            mask=None if flash else mask,
            dropout=None if flash else (
                lambda p: dropout(p, rate, generator, mesh,
                                  head_cuts(("tp", "cp")))))


def check_attn(attn_impl: str, mesh) -> None:
    """An attention core by name: one of :data:`ATTN_IMPLS`, the ring
    cores on a mesh (whose cp axis they rotate over)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if attn_impl in ("ring", "ring_pallas") and mesh is None:
        raise ValueError(f"attn_impl={attn_impl!r} requires mesh")


def gelu_tanh(x):
    # GPT-2's "gelu_new".
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    # ViT's and BERT's erf GELU.
    return F.gelu(x)


ACTIVATIONS = {"gelu_exact": gelu_exact, "gelu_tanh": gelu_tanh}


class Mlp(nn.Module):
    """fc_in, the activation, fc_out. On a ``mesh`` with tp > 1 the rank
    holds ``hidden_dim / tp`` units: fc_in column-parallel after the
    region's entry, fc_out row-parallel (``parallel.tp``)."""

    def __init__(self, embed_dim, hidden_dim, dtype, device=None,
                 dropout_rate: float = 0.0, mesh=None,
                 activation: str = "gelu_tanh",
                 sequence_parallel: bool = False):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of "
                             f"{sorted(ACTIVATIONS)}, got {activation!r}")
        self.act = ACTIVATIONS[activation]
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.tp = 1 if mesh is None else mesh.shape["tp"]
        self.sequence_parallel = sequence_parallel and self.tp > 1
        hidden = hidden_dim // self.tp
        self.fc_in = Dense((embed_dim,), (hidden,), dtype, device)
        if self.tp > 1:
            from ..parallel.tp import RowParallelDense

            self.fc_out = RowParallelDense(
                (hidden,), (embed_dim,), dtype, device, mesh=mesh,
                sequence_parallel=self.sequence_parallel)
        else:
            self.fc_out = Dense((hidden,), (embed_dim,), dtype, device)

    def forward(self, x, generator=None, seq_len: int | None = None):
        if self.tp > 1:
            from ..parallel.tp import enter

            x = enter(x, self.mesh, self.sequence_parallel, seq_len)
        h = self.fc_out(self.act(self.fc_in(x)))
        return dropout(h, self.dropout_rate, generator, self.mesh,
                       act_cuts(self.mesh, self.sequence_parallel, seq_len))


class TransformerBlock(nn.Module):
    """Pre-LN (GPT-2, ViT): x + drop(attn(ln1(x))), then x + mlp(ln2(x));
    post-LN (BERT): ln1(x + drop(attn(x))), then ln2(x + mlp(x)). The MLP
    applies its own output dropout. ``mask``: the attention core's
    key-padding mask; ``seq_len``: the sequence's length under sequence
    parallelism (``x`` is then a rank's shard of it)."""

    def __init__(self, embed_dim, num_heads, head_dim, mlp_dim, ln_eps,
                 dtype, device=None, *, pre_ln: bool = True,
                 causal: bool = True, activation: str = "gelu_tanh",
                 attn_impl: str = "xla", dropout_rate: float = 0.0,
                 mesh=None, sequence_parallel: bool = False):
        super().__init__()
        self.pre_ln = pre_ln
        self.dropout_rate, self.mesh = dropout_rate, mesh
        self.sequence_parallel = sequence_parallel and (
            mesh is not None and mesh.shape["tp"] > 1)
        self.attn = SelfAttention(embed_dim, num_heads, head_dim, dtype,
                                  device, causal=causal, attn_impl=attn_impl,
                                  dropout_rate=dropout_rate, mesh=mesh,
                                  sequence_parallel=sequence_parallel)
        self.mlp = Mlp(embed_dim, mlp_dim, dtype, device, dropout_rate, mesh,
                       activation, sequence_parallel=sequence_parallel)
        self.ln1 = LayerNorm(embed_dim, ln_eps, dtype, device)
        self.ln2 = LayerNorm(embed_dim, ln_eps, dtype, device)

    def forward(self, x, cache=None, layer: int = 0, *, mask=None,
                generator=None, seq_len: int | None = None):
        def drop(a):
            return dropout(a, self.dropout_rate, generator, self.mesh,
                           act_cuts(self.mesh, self.sequence_parallel,
                                    seq_len))

        if self.pre_ln:
            x = x + drop(self.attn(self.ln1(x), cache, layer, mask=mask,
                                   generator=generator, seq_len=seq_len))
            return x + self.mlp(self.ln2(x), generator, seq_len)
        x = self.ln1(x + drop(self.attn(x, cache, layer, mask=mask,
                                        generator=generator,
                                        seq_len=seq_len)))
        return self.ln2(x + self.mlp(x, generator, seq_len))


class TransformerStack(nn.Module):
    """N identically-configured blocks named ``block_{i}``. ``generator``
    (a ``torch.Generator`` on the activations' device) turns dropout on:
    training passes one, evaluation and serving pass none. ``mesh``: the
    ranks the activations are split over (dropout masks, the ring cores).
    ``remat`` ('none' | 'full' | 'dots', ``models/remat.py``) checkpoints
    each block of a forward without a KV cache; without remat, a block's
    leaves gathered over fsdp are freed when its forward ends
    (``parallel.fsdp.reshard_after_forward``)."""

    def __init__(self, num_layers, embed_dim, num_heads, head_dim, mlp_dim,
                 ln_eps, dtype, device=None, *, pre_ln: bool = True,
                 causal: bool = True, activation: str = "gelu_tanh",
                 remat: str = "none", attn_impl: str = "xla",
                 dropout_rate: float = 0.0, mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.num_layers, self.remat = num_layers, check_remat(remat)
        self.mesh = mesh
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, head_dim, mlp_dim, ln_eps, dtype,
                device, pre_ln=pre_ln, causal=causal, activation=activation,
                attn_impl=attn_impl, dropout_rate=dropout_rate, mesh=mesh,
                sequence_parallel=sequence_parallel))

    def forward(self, x, cache=None, *, mask=None, generator=None,
                seq_len: int | None = None):
        remat = self.remat if cache is None else "none"
        for i in range(self.num_layers):
            block = functools.partial(getattr(self, f"block_{i}"), cache=cache,
                                      layer=i, mask=mask, generator=generator,
                                      seq_len=seq_len)
            with block_scope(self.mesh, remat):
                x = checkpoint_block(block, x, remat=remat,
                                     generator=generator, module=block.func)
        return x


def block_scope(mesh, remat: str):
    """The scope of one block's forward: under fsdp without remat, its
    gathered leaves are freed at its end (under remat the checkpoint keeps
    none of them)."""
    if remat == "none":
        return reshard_after_forward(mesh)
    return contextlib.nullcontext()
