"""The port's paged-decode attention against the JAX package's.

The same numpy inputs go through the JAX Pallas kernel (interpret mode on
the CPU, as tests/test_paged_attention.py runs it), the JAX gather oracle
``paged_attention_reference``, and the port's ``paged_attention`` — which on
a CPU tensor is its plain torch version. fp32 cases hold atol 1e-5; int8
pools hold 2e-5 (the quantized reference's bar); bf16 pools 2e-2 (one bf16
rounding of unit-scale outputs). ``split_merge`` emulates the CUDA kernel's
arithmetic in plain torch (each split's partial softmax, then the merge)
and is held against the Pallas kernel at the same tolerances. The CUDA
kernel itself is held against the plain version on the card (``gpu``
marker, and chip_smoke.py). JAX is imported inside the helpers that use it,
so the ``gpu`` tests run on a GPU host without JAX:

    python -m pytest tests/test_torch_paged_attention.py --noconftest -m gpu
"""

import functools
import math

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)


def _case(seed, *, B, kv_heads, num_rep, D, num_blocks, block_size, pages,
          lens, quantized=False, contiguous=False):
    """Pool + page tables with the engine's invariants: block 0 is the null
    block, live rows own disjoint (shuffled) blocks, idle rows (cursor 0)
    park their whole table on the null block."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, kv_heads * num_rep, D)).astype(np.float32)
    shape = (num_blocks, block_size, kv_heads, D)
    if quantized:
        pool_k = rng.integers(-127, 128, shape).astype(np.int8)
        pool_v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = [
            (rng.random(shape[:3]) / 127).astype(np.float32) for _ in "kv"
        ]
    else:
        pool_k = rng.standard_normal(shape).astype(np.float32)
        pool_v = rng.standard_normal(shape).astype(np.float32)
        scales = [None, None]
    ids = np.arange(1, num_blocks)
    if not contiguous:
        ids = rng.permutation(ids)
    table = np.zeros((B, pages), np.int32)
    used = 0
    for b, ln in enumerate(lens):
        if ln == 0:
            continue
        need = ln // block_size + 1
        table[b, :need] = ids[used:used + need]
        used += need
    assert used <= ids.size
    return dict(q=q, pool_k=pool_k, pool_v=pool_v, page_table=table,
                seq_lens=np.asarray(lens, np.int32), scale_k=scales[0],
                scale_v=scales[1])


def _jax(args, num_rep, bf16=False):
    """The JAX Pallas kernel (interpret mode on the CPU) and the JAX gather
    oracle on ``args``; fp32 operands go in as bf16 with ``bf16``."""
    import jax.numpy as jnp

    from distributeddeeplearning_tpu.ops import (
        paged_attention as jax_paged_attention,
        paged_attention_reference as jax_reference,
    )

    a = {k: (None if v is None else jnp.asarray(v)) for k, v in args.items()}
    for k in ("q", "pool_k", "pool_v"):
        if bf16 and a[k].dtype == jnp.float32:
            a[k] = a[k].astype(jnp.bfloat16)
    pos = [a.pop(k) for k in ("q", "pool_k", "pool_v", "page_table",
                              "seq_lens")]
    kern = jax_paged_attention(*pos, num_rep=num_rep, **a)
    ref = jax_reference(*pos, num_rep=num_rep, **a)
    return np.asarray(kern, np.float32), np.asarray(ref, np.float32)


def _torch(args, num_rep, fn=pa.paged_attention, dtype=torch.float32):
    t = {k: (None if v is None else torch.from_numpy(v))
         for k, v in args.items()}
    for k in ("q", "pool_k", "pool_v"):
        if t[k].dtype == torch.float32:
            t[k] = t[k].to(dtype)
    out = fn(t.pop("q"), t.pop("pool_k"), t.pop("pool_v"),
             t.pop("page_table"), t.pop("seq_lens"), num_rep=num_rep, **t)
    return out.float().numpy()


_FP_CASES = {
    # Cursors on a page boundary, mid-page, first page and deep, plus an
    # idle row on the null block.
    "mixed_cursors": dict(B=4, kv_heads=3, num_rep=1, D=16, num_blocks=32,
                          block_size=8, pages=6, lens=[0, 7, 8, 37]),
    "gqa_rep2": dict(B=3, kv_heads=2, num_rep=2, D=16, num_blocks=24,
                     block_size=8, pages=5, lens=[15, 16, 33]),
    "idle_rows": dict(B=3, kv_heads=2, num_rep=1, D=8, num_blocks=8,
                      block_size=8, pages=3, lens=[0, 0, 9]),
    "single_page": dict(B=1, kv_heads=1, num_rep=1, D=8, num_blocks=4,
                        block_size=8, pages=1, lens=[5]),
}


@pytest.mark.parametrize("name", sorted(_FP_CASES))
def test_plain_matches_jax_kernel_and_reference_fp32(name):
    cfg = _FP_CASES[name]
    args = _case(1, **cfg)
    kern, ref = _jax(args, cfg["num_rep"])
    ours = _torch(args, cfg["num_rep"])
    np.testing.assert_allclose(ours, kern, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    assert np.isfinite(ours).all()


def test_bf16_pool_matches_jax():
    cfg = dict(B=3, kv_heads=2, num_rep=2, D=16, num_blocks=16,
               block_size=8, pages=4, lens=[3, 17, 0])
    args = _case(2, **cfg)
    kern, _ = _jax(args, 2, bf16=True)
    ours = _torch(args, 2, dtype=torch.bfloat16)
    np.testing.assert_allclose(ours, kern, atol=2e-2, rtol=2e-2)


def test_scattered_table_equals_contiguous():
    # The same logical sequences through a shuffled and a contiguous table:
    # only the block ids differ, so after laying the pools out to match,
    # the outputs are identical.
    cfg = dict(B=2, kv_heads=2, num_rep=1, D=8, num_blocks=12,
               block_size=4, pages=5, lens=[9, 17])
    scat = _case(3, **cfg)
    cont = _case(3, contiguous=True, **cfg)
    cont["q"] = scat["q"]
    for name in ("pool_k", "pool_v"):
        pool = np.zeros_like(scat[name])
        for b in range(2):
            for j in range(cfg["pages"]):
                src, dst = scat["page_table"][b, j], cont["page_table"][b, j]
                if src:
                    pool[dst] = scat[name][src]
        cont[name] = pool
    np.testing.assert_array_equal(_torch(scat, 1), _torch(cont, 1))
    kern, _ = _jax(cont, 1)
    np.testing.assert_allclose(_torch(cont, 1), kern, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_rep", [1, 2])
def test_int8_pool_with_scales_matches_jax(num_rep):
    cfg = dict(B=4, kv_heads=2, num_rep=num_rep, D=16, num_blocks=24,
               block_size=8, pages=5, lens=[0, 7, 8, 33])
    args = _case(4, quantized=True, **cfg)
    kern, ref = _jax(args, num_rep)
    ours = _torch(args, num_rep)
    np.testing.assert_allclose(ours, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def split_merge(q, pool_k, pool_v, page_table, seq_lens, *, scale_k=None,
                scale_v=None, num_rep=1, split=64):
    """The CUDA kernel's arithmetic (``csrc/paged_attention.cu``) in plain
    fp32 torch: row b's columns, clamped to the table, are cut into splits
    of ``split``; each split that holds a visible column computes its
    scores from the pre-scaled q (an int8 row's scale applied to the dot
    product), its max m, l = sum exp(s - m) and the unnormalised o = sum
    exp(s - m) * v (the int8 value scale folded into the weight); the merge
    rescales each live split by exp(m_s - m_max) and divides by the
    rescaled l. Returns [B, H, D] fp32."""
    B, H, D = q.shape
    _, bs, kv_heads, _ = pool_k.shape
    columns = page_table.shape[1] * bs
    n_splits = -(-columns // split)
    qf = q.float() * torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf = qf.reshape(B, kv_heads, num_rep, D)
    o = torch.zeros(B, kv_heads, num_rep, n_splits, D)
    m = torch.full((B, kv_heads, num_rep, n_splits), -1e30)
    l_ = torch.zeros(B, kv_heads, num_rep, n_splits)
    out = torch.zeros(B, kv_heads, num_rep, D)
    for b in range(B):
        last = min(int(seq_lens[b]), columns - 1)
        live = 0 if last < 0 else last // split + 1
        for sp in range(live):
            cols = torch.arange(sp * split, min((sp + 1) * split, columns))
            rows = page_table[b, cols // bs].long(), cols % bs
            k, v = pool_k[rows].float(), pool_v[rows].float()  # [n, G, D]
            s = torch.einsum("grd,ngd->grn", qf[b], k)
            if scale_k is not None:
                s = s * scale_k[rows].T[:, None, :]
            s = torch.where(cols <= last, s, torch.tensor(-1e30))
            m[b, ..., sp] = s.amax(-1)
            p = torch.exp(s - m[b, ..., sp, None])
            l_[b, ..., sp] = p.sum(-1)
            if scale_v is not None:
                p = p * scale_v[rows].T[:, None, :]
            o[b, ..., sp, :] = torch.einsum("grn,ngd->grd", p, v)
        if live:
            w = torch.exp(m[b, ..., :live] - m[b, ..., :live].amax(-1, True))
            total = (w * l_[b, ..., :live]).sum(-1)
            acc = (w[..., None] * o[b, ..., :live, :]).sum(-2)
            out[b] = acc / total.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D)


# Cursors on and around page (16) and split (64, 128) boundaries, an idle
# row (0) and the deepest column of a 64-page table (1023).
_SPLIT_LENS = [0, 1, 15, 16, 63, 64, 65, 127, 128, 1023]
_SPLIT_CASES = {
    "d64": dict(kv_heads=2, num_rep=1, D=64),
    "d128": dict(kv_heads=2, num_rep=1, D=128),
    "gqa_rep2": dict(kv_heads=2, num_rep=2, D=64),
    "int8": dict(kv_heads=2, num_rep=1, D=64, quantized=True),
}


@functools.lru_cache(maxsize=None)
def _split_case(name):
    cfg = dict(_SPLIT_CASES[name])
    lens = _SPLIT_LENS
    pages_used = sum(n // 16 + 1 for n in lens if n)
    args = _case(8, B=len(lens), block_size=16, pages=64, lens=lens,
                 num_blocks=1 + pages_used, **cfg)
    kern, _ = _jax(args, cfg["num_rep"])
    return args, cfg["num_rep"], kern


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("name", sorted(_SPLIT_CASES))
def test_split_merge_emulation_matches_jax_kernel(name, split):
    """The kernel's split-and-merge, emulated, against the Pallas kernel in
    interpret mode: fp32 atol 1e-5, the int8 pool 2e-5."""
    args, num_rep, kern = _split_case(name)
    t = {k: (None if v is None else torch.from_numpy(v))
         for k, v in args.items()}
    ours = split_merge(t.pop("q"), t.pop("pool_k"), t.pop("pool_v"),
                       t.pop("page_table"), t.pop("seq_lens"),
                       num_rep=num_rep, split=split, **t).numpy()
    atol = 2e-5 if name == "int8" else 1e-5
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, kern, atol=atol, rtol=atol)


_OPERAND_ERRORS = {
    "head_dim_32": "head_dim 32 is not built",
    "pool_k_misaligned": "pool_k at 0x[0-9a-f]+ is not 16-byte aligned",
    "pool_v_misaligned": "pool_v at 0x[0-9a-f]+ is not 16-byte aligned",
    "page_table_misaligned": "page_table at 0x[0-9a-f]+ is not 16-byte",
}


@pytest.mark.parametrize("kind", sorted(_OPERAND_ERRORS))
def test_kernel_operand_checks_by_name(kind):
    """What the wrapper refuses before a CUDA launch, checked here on CPU
    tensors: a head dim the kernel is not built for, and a pool or table
    that does not start on a 16-byte boundary (a view one element in)."""
    D = 32 if kind == "head_dim_32" else 64

    def aligned(*shape, dtype):
        return torch.zeros(math.prod(shape) + 16, dtype=dtype)[:math.prod(
            shape)].view(shape)

    def shifted(*shape, dtype):
        return torch.zeros(math.prod(shape) + 16, dtype=dtype)[1:1 + math.prod(
            shape)].view(shape)

    ops = {"q": aligned(2, 2, D, dtype=torch.float32),
           "pool_k": aligned(4, 16, 2, D, dtype=torch.bfloat16),
           "pool_v": aligned(4, 16, 2, D, dtype=torch.bfloat16),
           "page_table": aligned(2, 3, dtype=torch.int32)}
    name = kind.replace("_misaligned", "")
    if name in ops:
        ops[name] = shifted(*ops[name].shape, dtype=ops[name].dtype)
    with pytest.raises(ValueError, match=_OPERAND_ERRORS[kind]):
        pa.check_kernel_operands(**ops)
    assert all(t.data_ptr() % 16 == 0 for k, t in ops.items() if k != name)


def test_kernel_operand_checks_pass_the_engine_layout():
    # The pools and table as the engine allocates them: nothing to refuse.
    for D in pa.HEAD_DIMS:
        pa.check_kernel_operands(
            torch.zeros(2, 4, D, dtype=torch.bfloat16),
            torch.zeros(9, 16, 4, D, dtype=torch.int8),
            torch.zeros(9, 16, 4, D, dtype=torch.int8),
            torch.zeros(2, 4, dtype=torch.int32))


def test_wrapper_on_cpu_runs_plain_version_and_launches_nothing():
    cfg = _FP_CASES["mixed_cursors"]
    args = _case(5, **cfg)
    pa.reset_launches()
    a = _torch(args, 1)
    b = _torch(args, 1, fn=pa.paged_attention_plain)
    np.testing.assert_array_equal(a, b)
    assert pa.LAUNCHES == {"paged_decode": 0, "paged_decode_q8": 0}


def _bad(kind):
    cfg = dict(B=2, kv_heads=2, num_rep=1, D=8, num_blocks=8, block_size=4,
               pages=3, lens=[3, 5])
    args = _case(6, quantized=kind.startswith("q8"), **cfg)
    t = {k: (None if v is None else torch.from_numpy(v))
         for k, v in args.items()}
    if kind == "pool_mismatch":
        t["pool_v"] = t["pool_v"][:, :2]
    elif kind == "head_mismatch":
        t["q"] = torch.zeros(2, 3, 8)
    elif kind == "table_rows":
        t["page_table"] = t["page_table"][:1]
    elif kind == "scales_on_fp":
        t["scale_k"] = torch.zeros(8, 4, 2)
    elif kind == "q8_missing_scale":
        t["scale_v"] = None
    elif kind == "q8_scale_shape":
        t["scale_k"] = t["scale_k"][:, :2]
    return t


_ERRORS = {
    "pool_mismatch": "pool_k/pool_v shapes differ",
    "head_mismatch": "incompatible with pool",
    "table_rows": "must be \\[B=2, pages\\]",
    "scales_on_fp": "scale_k/scale_v passed with a non-int8 pool",
    "q8_missing_scale": "int8 pool without scale_v",
    "q8_scale_shape": "scale_k shape",
}


@pytest.mark.parametrize("kind", sorted(_ERRORS))
@pytest.mark.parametrize(
    "fn", [pa.paged_attention, pa.paged_attention_plain],
    ids=["wrapper", "plain"],
)
def test_validation_errors_by_name(kind, fn):
    t = _bad(kind)
    with pytest.raises(ValueError, match=_ERRORS[kind]):
        fn(t.pop("q"), t.pop("pool_k"), t.pop("pool_v"), t.pop("page_table"),
           t.pop("seq_lens"), num_rep=1, **t)


# name: (pool type, q bf16, num_rep, D, cursors). ``int8_bf16q`` is the
# serving path's int8 case: a bf16 q (the model's compute dtype) over the
# int8 pool; ``int8`` holds the same kernel at fp32 q to the tight
# tolerance. ``split_cursors`` puts cursors on and beside 64- and
# 128-column splits and the 16-slot pages.
_LENS = [0, 1, 15, 16, 300, 511, 0, 1023]
_GPU_CASES = {
    "float32": ("float32", False, 1, 64, _LENS),
    "bfloat16": ("float32", True, 1, 64, _LENS),
    "int8": ("int8", False, 1, 64, _LENS),
    "int8_bf16q": ("int8", True, 1, 64, _LENS),
    "gqa4": ("float32", False, 4, 64, _LENS),
    "bf16_d128": ("float32", True, 1, 128, _LENS),
    "float32_d128": ("float32", False, 1, 128, _LENS),
    "bf16_gqa2": ("float32", True, 2, 64, _LENS),
    "bf16_d16": ("float32", True, 1, 16, _LENS),
    "split_cursors": ("float32", True, 1, 64,
                      [63, 64, 127, 128, 255, 256, 1022, 1023]),
    "split_cursors_int8_fp32q": ("int8", False, 1, 64,
                                 [0, 63, 64, 65, 127, 128, 129, 1023]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("pool", list(_GPU_CASES))
def test_cuda_kernel_matches_plain_version(pool):
    """The kernel against its plain version on the card: bf16 at 2e-2, fp32
    q at 2e-5 (only the order of the fp32 sums differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kind, bf16, num_rep, D, lens = _GPU_CASES[pool]
    cfg = dict(B=8, kv_heads=12 // num_rep, num_rep=num_rep, D=D,
               num_blocks=8 * 64 + 1, block_size=16, pages=64, lens=lens)
    args = _case(7, quantized=kind == "int8", **cfg)
    dtype = torch.bfloat16 if bf16 else torch.float32
    t = {k: (None if v is None else torch.from_numpy(v).cuda())
         for k, v in args.items()}
    for k in ("q", "pool_k", "pool_v"):
        if t[k].dtype == torch.float32:
            t[k] = t[k].to(dtype)
    pos = [t.pop(k) for k in ("q", "pool_k", "pool_v", "page_table",
                              "seq_lens")]
    before = dict(pa.LAUNCHES)
    out = pa.paged_attention(*pos, num_rep=num_rep, **t)
    torch.cuda.synchronize()
    assert sum(pa.LAUNCHES.values()) == sum(before.values()) + 1
    ref = pa.paged_attention_plain(*pos, num_rep=num_rep, **t)
    atol = 2e-2 if bf16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.gpu
def test_cuda_kernel_refuses_head_dim_by_name():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _case(9, B=2, kv_heads=2, num_rep=1, D=32, num_blocks=8,
                 block_size=16, pages=3, lens=[3, 40])
    t = {k: (None if v is None else torch.from_numpy(v).cuda())
         for k, v in args.items()}
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="head_dim 32 is not built"):
        pa.paged_attention(t.pop("q"), t.pop("pool_k"), t.pop("pool_v"),
                           t.pop("page_table"), t.pop("seq_lens"))
    assert pa.LAUNCHES == before
