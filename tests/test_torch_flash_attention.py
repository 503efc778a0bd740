"""The port's flash attention against the JAX package's.

The JAX kernels (``_fwd``, ``_bwd``) run in Pallas interpret mode, as the
JAX package's own tests run them on the CPU, at ``block_q = block_k = 32``
over L = 64 so every case crosses block edges; the port's plain versions
(what its wrappers run for CPU tensors) get the same numpy inputs. fp32
agrees within 1e-5; bf16 within 2e-2 (both round o, dq, dk, dv to bf16's 8
mantissa bits at the output, and may round a value to neighbouring bf16
numbers). ``jax.grad`` of ``flash_attention`` is held against
``torch.autograd`` through the port's ``autograd.Function``. The bf16
tensor-core ``flash_dq`` kernel's rounding of dS is emulated in plain torch
and held to the card checks' tolerance. The CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.models.transformer import (
    SelfAttention,
    attention_core,
)
from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

# The JAX ops package exports the function under the module's name.
jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)

BH, L, D, BLK = 4, 64, 16, 32
SCALE = 1.0 / np.sqrt(D)
# name: (causal, per-row kv limits or None, true length of a padded L)
CASES = {
    "causal": (True, None, None),
    "kv_valid_lens": (False, [64, 13, 40, 1], None),
    "padded_L50": (False, None, 50),
    "causal_padded_L50": (True, None, 50),
}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, valid=None):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((BH, L, D)).astype(np.float32)
                   for _ in range(4))
    if valid is not None:  # the wrapper's zero pad, and a zero cotangent
        for x in (q, k, v, do):
            x[:, valid:] = 0
    return q, k, v, do


def _jax_fwd(q, k, v, jdt, causal, vl, valid):
    vla = jnp.asarray(vl if vl is not None else [L] * BH, jnp.int32)
    return jfa._fwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                    jnp.asarray(v, jdt), vla, causal, SCALE, BLK, BLK, True,
                    valid, vl is not None)


def _close(a, b, tol, rows=None):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if rows is not None:
        a, b = a[:, :rows], b[:, :rows]
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _t(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_fwd_matches_jax_kernel(case, dtype):
    causal, vl, valid = CASES[case]
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(0, valid)
    o_j, lse_j = _jax_fwd(q, k, v, jdt, causal, vl, valid)
    tvl = None if vl is None else torch.tensor(vl, dtype=torch.int32)
    o, lse = fa.flash_fwd_plain(
        *(_t(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
          for x in (q, k, v)),
        causal=causal, sm_scale=SCALE, limit=valid or L, vl=tvl)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _close(o.float(), o_j, tol, rows=valid)
    _close(lse, np.asarray(lse_j)[..., 0], tol, rows=valid)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_matches_jax_kernel(case, dtype):
    causal, vl, valid = CASES[case]
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, do = _inputs(1, valid)
    o_j, lse_j = _jax_fwd(q, k, v, jdt, causal, vl, valid)
    vla = jnp.asarray(vl if vl is not None else [L] * BH, jnp.int32)
    res = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
           vla, o_j, lse_j)
    dq_j, dk_j, dv_j, _ = jfa._bwd(causal, SCALE, BLK, BLK, True, valid,
                                   vl is not None, res,
                                   jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (_t(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
                       for x in (q, k, v, do))
    to = _t(np.asarray(o_j, np.float32), tdt)
    tlse = torch.from_numpy(np.asarray(lse_j)[..., 0].copy())
    kw = dict(causal=causal, sm_scale=SCALE, limit=valid or L,
              vl=None if vl is None else torch.tensor(vl, dtype=torch.int32))
    dq, delta = fa.flash_dq_plain(tq, tk, tv, to, tdo, tlse, **kw)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, tlse, delta, **kw)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == tdt
        _close(got.float(), want, tol, rows=valid)


GRAD_CASES = {
    "causal": dict(causal=True, s=64),
    "padded_s50": dict(causal=False, s=50),
    "causal_padded_s50": dict(causal=True, s=50),
    "kv_valid_lens": dict(causal=False, s=64, vl=[64, 23]),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grad_matches_jax_autodiff(case):
    """jax.grad through the reference's custom_vjp == torch.autograd through
    the port's FlashAttentionFunction, over [batch, seq, heads, dim]."""
    c = GRAD_CASES[case]
    s, vl = c["s"], c.get("vl")
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((2, s, 2, D)).astype(np.float32)
                   for _ in range(4))

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=c["causal"], block_q=BLK,
                                block_k=BLK, interpret=True,
                                kv_valid_lens=vl)
        return jnp.sum(o * do), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_()
                  for x in (q, k, v))
    o = fa.flash_attention(tq, tk, tv, causal=c["causal"], block_q=BLK,
                           block_k=BLK, kv_valid_lens=vl)
    g = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    _close(o.detach(), o_j, 1e-5)
    for a, b in zip(g, g_j):
        _close(a, b, 1e-5)


def _flash_dq_tc_emulated(q, k, v, o, do, lse, **kw):
    """flash_dq as the bf16 tensor-core kernel computes it: dS rounded to
    bf16 inside dS K (one term, as flash_dkv rounds it), dq rounded to bf16
    at the output."""
    p = fa._probs(q, k, lse, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    dq = kw["sm_scale"] * torch.einsum("bqk,bkd->bqd", ds, k.float())
    return dq.to(q.dtype), delta


@pytest.mark.parametrize("head_dim", [64, 128])
def test_tensor_core_dq_rounding_stays_inside_the_tolerance(head_dim):
    """The bf16 flash_dq kernel's rounding of dS, causal with per-row kv
    limits, against the plain version at the card checks' 2e-2 + 2e-2
    |ref|; the rounding moves dq, so the check is not vacuous."""
    rng = np.random.default_rng(7)
    bh, n, tol = 4, 96, 2e-2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, n, head_dim))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, sm_scale=head_dim ** -0.5, limit=n,
              vl=torch.tensor([96, 33, 40, 5], dtype=torch.int32))
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    got, delta = _flash_dq_tc_emulated(q, k, v, o, do, lse, **kw)
    want, delta_p = fa.flash_dq_plain(q, k, v, o, do, lse, **kw)
    a, b = got.float(), want.float()
    used = ((a - b).abs() / (tol + tol * b.abs())).max().item()
    assert used <= 1, f"dq: {used:.3f} of the tolerance"
    assert not torch.equal(got, want)
    assert torch.equal(delta, delta_p)


def test_wrappers_on_cpu_run_plain_versions_and_launch_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3))
    before = dict(fa.LAUNCHES)
    kw = dict(causal=True, sm_scale=SCALE, limit=L)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert fa.LAUNCHES == before
    o_p, _ = fa.flash_fwd_plain(q, k, v, **kw)
    assert torch.equal(o, o_p)


@pytest.mark.parametrize("bad,match", [
    ("head_dim", "head_dim 16 not in"),
    ("dtype", "dtype torch.float16"),
    ("contiguous", "must be contiguous"),
    ("lse_dtype", "lse is torch.float64"),
])
def test_kernel_operand_checks_by_name(bad, match):
    """What a CUDA launch refuses, checked before the launch (device last,
    so the checks can be held here on CPU tensors)."""
    dim = 16 if bad == "head_dim" else 64
    dt = torch.float16 if bad == "dtype" else torch.float32
    q = torch.zeros(2, 8, dim, dtype=dt)
    k = q.transpose(0, 1).contiguous().transpose(0, 1) if (
        bad == "contiguous") else q.clone()
    t = {"q": q, "k": k, "v": q.clone()}
    if bad == "lse_dtype":
        t["lse"] = torch.zeros(2, 8, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError), match=match):
        fa._check("flash_fwd", t, None)


def test_attention_core_flash_matches_xla_core():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 3, D))
                                .astype(np.float32)) for _ in range(3))
    a = attention_core(q, k, v, causal=True, dtype=torch.float32,
                       impl="flash")
    b = attention_core(q, k, v, causal=True, dtype=torch.float32)
    _close(a, b, 1e-5)


def test_self_attention_prefix_mask_and_nan_poison():
    """A contiguous-prefix key mask becomes per-row kv limits (the xla
    core's answer); a row whose mask is no prefix is poisoned to NaN, as in
    the reference."""
    torch.manual_seed(0)
    attn = SelfAttention(32, 2, D, torch.float32, attn_impl="flash")
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(3, 24, 32)
    mask = torch.ones(3, 24, dtype=torch.bool)
    mask[0, 10:] = False
    mask[2, 5] = False  # a hole: not a prefix
    out = attn(x, mask=mask)
    attn.attn_impl = "xla"
    ref = attn(x, mask=mask)
    _close(out[:2].detach(), ref[:2].detach(), 1e-5)
    assert torch.isnan(out[2]).all()
    attn.attn_impl, attn.dropout_rate = "flash", 0.1
    with pytest.raises(NotImplementedError, match="attention-dropout"):
        attn(x, generator=torch.Generator())


def test_causal_with_kv_valid_lens_matches_xla_core():
    """Causal together with per-row kv limits, which the reference's kernel
    does not lower in interpret mode: held against the xla core under the
    causal mask and the same prefix key mask."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 48, 2, D))
                                .astype(np.float32)) for _ in range(3))
    vl = torch.tensor([48, 17, 5])
    a = fa.flash_attention(q, k, v, causal=True, kv_valid_lens=vl,
                           block_q=BLK, block_k=BLK)
    mask = torch.arange(48)[None, :] < vl[:, None]
    b = attention_core(q, k, v, causal=True, dtype=torch.float32, mask=mask)
    _close(a, b, 1e-5)
