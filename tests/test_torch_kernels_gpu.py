"""The training kernels of the port against their plain versions, on the card:
flash attention, fused AdamW and the ring attention block kernels; and the
paged decode kernels under grouped-query attention at Llama-300M's decode
shape (the other paged cases are in ``tests/test_torch_paged_attention.py``).

Imports torch and the port only, so it runs on a GPU host without JAX:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

(``--noconftest``: the suite's conftest sets JAX up.) Every test carries
the ``gpu`` marker and skips where torch sees no CUDA device; the kernels
have no CPU mode. Tolerances: paged decode with bf16 q 2e-2 (the output is
rounded to bf16, and P is rounded to bf16 inside P V); flash in fp32 2e-5 (only the order of fp32
sums differs), in bf16 2e-2 absolute and relative: one bf16 rounding step of
the output is ~0.4%, and the tensor-core fwd, dq and dk/dv kernels also
round P and dS to bf16 inside the P V, dS K, P^T dO and dS^T Q products
(~0.2% per term, with random signs, so it grows far slower than the sum);
fused AdamW bit for bit (every operation rounds on its own in both). The
ring kernels' outputs are fp32 carries: 2e-5 in fp32 (only the order of the
fp32 sums differs). With bf16 inputs every ring kernel runs on the tensor
cores, where the bf16 inputs are exact. ring_dkv rounds where the flash
kernels do (P inside P^T dO, dS inside dS^T Q): their 2e-2 absolute and
relative. ring_step feeds its products P, and qf at D = 128, as two bf16
terms each, and ring_dq feeds dS K with dS as two bf16 terms (~2^-16 left
of each), so their carries keep the fp32 design's 2e-3: again only the
order of the sums differs, over larger magnitudes.
"""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused
from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas as rp

# name: (causal, per-row kv limits or None, true length of a padded L, L).
# L = 100 is no multiple of the kernels' 64-row tiles: what flash_attention
# hands them, unpadded, for a sequence shorter than its blocks. L = 1000 and
# L = 200 end in a partial tile of the bf16 kernels' 128-row (64 at D = 128)
# q tiles and 64-row kv tiles, with the causal diagonal or a row whose only
# visible column is column 0.
FLASH_CASES = {
    "causal": (True, None, None, 128),
    "kv_valid_lens": (False, [128, 13, 40, 1], None, 128),
    "causal_kv_valid_lens": (True, [128, 33, 40, 5], None, 128),
    "padded_L100": (False, None, 100, 128),
    "causal_padded_L100": (True, None, 100, 128),
    "causal_L100": (True, None, None, 100),
    "kv_valid_lens_L100": (False, [100, 7, 64, 65], None, 100),
    "causal_L1000": (True, None, None, 1000),
    "kv_valid_lens_L200": (False, [200, 1, 129, 64], None, 200),
    # Llama-300M's training sequence: 32 q tiles of the causal walk.
    "causal_L2048": (True, None, None, 2048),
}
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain_versions(case, dtype, head_dim):
    _need_cuda()
    causal, vl, valid, L = FLASH_CASES[case]
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, L, head_dim))
                                    .astype(np.float32)).to("cuda")
                   for _ in range(4))
    if valid is not None:  # the wrapper's zero pad
        for x in (q, k, v, do):
            x[:, valid:] = 0
    q, k, v, do = (x.to(tdt) for x in (q, k, v, do))
    kw = dict(causal=causal, sm_scale=head_dim ** -0.5, limit=valid or L,
              vl=None if vl is None else torch.tensor(
                  vl, dtype=torch.int32, device="cuda"))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    dq, delta = fa.flash_dq(q, k, v, o_p, do, lse_p, **kw)
    dq_p, delta_p = fa.flash_dq_plain(q, k, v, o_p, do, lse_p, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_p, delta_p, **kw)
    dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse_p, delta_p, **kw)
    torch.cuda.synchronize()
    assert all(fa.LAUNCHES[x] == before[x] + 1 for x in before)
    n = valid or L
    for a, b in ((o, o_p), (lse, lse_p), (dq, dq_p), (delta, delta_p),
                 (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(a[:, :n].float(), b[:, :n].float(),
                                   atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_autograd_runs_the_three_kernels():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 200, 3, 64, generator=g, device="cuda")
               .requires_grad_() for _ in range(3))
    before = dict(fa.LAUNCHES)
    o = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o.square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert all(fa.LAUNCHES[x] == before[x] + 1 for x in before)
    ref = fa.attention_reference(q, k, v, causal=True)
    ref_grads = torch.autograd.grad(ref.square().sum(), (q, k, v))
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=2e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_refuses_head_dim_by_name():
    _need_cuda()
    q = torch.zeros(2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim 32 not in"):
        fa.flash_fwd(q, q, q, causal=True, sm_scale=1.0, limit=8)


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1, 1000])
@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_fused_adamw_kernel_matches_plain_bitwise(wd, count):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(count)
    shapes = [(50257, 768), (768, 12, 64), (3072,), (1027,)]
    t = [[torch.randn(s, generator=g, device="cuda") * sc for s in shapes]
         for sc in (0.02, 1e-3, 1e-4, 1e-7)]
    t[3] = [x.abs() for x in t[3]]
    ref = [[x.clone() for x in xs] for xs in t]
    c1, c2 = fused.bias_corrections(0.9, 0.95, count)
    hp = dict(lr=6e-4, b1=0.9, b2=0.95, eps=1e-8, wd=wd, c1=c1, c2=c2)
    before = fused.LAUNCHES["fused_adamw"]
    fused.fused_adamw_group(*t, **hp)
    for leaf in zip(*ref):
        fused.fused_adamw_plain(*leaf, **hp)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_adamw"] == before + 1
    for xs, ys in zip(t, ref):
        for a, b in zip(xs, ys):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_fused_adamw_kernel_over_an_offset_padded_shard(rank):
    """A ZeRO-1 rank's update: a flat buffer of a group's leaves, padded to
    a multiple of 4 x 4 ranks, cut into 4 shards; the shard of ``rank``
    starts inside the buffer (16-byte aligned) and ends in the padding for
    the last rank. Bit for bit against the plain version, the padding
    untouched."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroLayout

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(rank)
    shapes = {"a.kernel": (768, 2304), "b.kernel": (1027, 3), "c.bias": (5,)}
    params = {k: torch.randn(s, generator=g, device="cuda") * 0.02
              for k, s in shapes.items()}
    lay = ZeroLayout(params, Mesh({"dp": 4}, rank))
    lay.bind(params)
    flat = lay.flats["decay"]
    sl = lay.shard_slice("decay")
    assert sl.start > 0 or rank == 0
    p = flat[sl]
    gr, m = (torch.randn(p.shape, generator=g, device="cuda") * sc
             for sc in (1e-3, 1e-4))
    v = (torch.randn(p.shape, generator=g, device="cuda") * 1e-7).abs()
    used = sum(params[k].numel() for k in lay.names["decay"])
    for x in (gr, m, v):  # the padding's gradient and moments are zero
        x[max(used - sl.start, 0):].zero_()
    ref = [x.clone() for x in (p, gr, m, v)]
    c1, c2 = fused.bias_corrections(0.9, 0.95, 10)
    hp = dict(lr=6e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=c1, c2=c2)
    before = fused.LAUNCHES["fused_adamw"]
    fused.fused_adamw_group([p], [gr], [m], [v], **hp)
    fused.fused_adamw_plain(*ref, **hp)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_adamw"] == before + 1
    for a, b in zip((p, m, v), (ref[0], ref[2], ref[3])):
        assert torch.equal(a, b)
    assert not flat[used:].any()


# L = 100 and 200 are no multiple of the kernels' 64-row tiles (nor of the
# bf16 ring_step's 128-row q tiles): the kernels hide the ragged edge
# themselves. Tolerances per kernel (module docstring).
RING_DTYPES = {
    "float32": (torch.float32, dict.fromkeys(rp.LAUNCHES, 2e-5)),
    "bfloat16": (torch.bfloat16,
                 {"ring_step": 2e-3, "ring_dq": 2e-3, "ring_dkv": 2e-2}),
}
RING_OUTPUTS = (("m", "ring_step"), ("l", "ring_step"), ("acc", "ring_step"),
                ("dq", "ring_dq"), ("dk", "ring_dkv"), ("dv", "ring_dkv"))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [128, 100, 200])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("dtype", list(RING_DTYPES))
@pytest.mark.parametrize("mode", [0, 1])
def test_ring_kernels_match_plain_versions(mode, dtype, head_dim, L):
    _need_cuda()
    tdt, tol = RING_DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    bh, scale = 6, head_dim ** -0.5
    q, kt, vt, do = (rnd(bh, L, head_dim, dt=tdt) for _ in range(4))
    qf = q.float() * scale
    m, l, acc = rnd(bh, L, 1), rnd(bh, L, 1).abs() + 0.5, rnd(bh, L, head_dim)
    # lse of the block itself, so p is a softmax; delta, dq, dk, dv random.
    s = rp._scores(qf, kt, mode)
    lse = torch.logsumexp(s, -1, keepdim=True)
    delta, dq, dk, dv = (rnd(bh, L, 1), rnd(bh, L, head_dim),
                         rnd(bh, L, head_dim), rnd(bh, L, head_dim))
    before = dict(rp.LAUNCHES)
    got = [*rp.ring_step(qf, kt, vt, m, l, acc, mode),
           rp.ring_dq(q, kt, vt, do, lse, delta, dq, mode, scale),
           *rp.ring_dkv(q, kt, vt, do, lse, delta, dk, dv, mode, scale)]
    want = [*rp.ring_step_plain(qf, kt, vt, m, l, acc, mode),
            rp.ring_dq_plain(q, kt, vt, do, lse, delta, dq, mode, scale),
            *rp.ring_dkv_plain(q, kt, vt, do, lse, delta, dk, dv, mode,
                               scale)]
    torch.cuda.synchronize()
    assert all(rp.LAUNCHES[x] == before[x] + 1 for x in before)
    for (name, kernel), a, b in zip(RING_OUTPUTS, got, want):
        torch.testing.assert_close(a, b, atol=tol[kernel], rtol=tol[kernel],
                                   msg=name)


@pytest.mark.gpu
def test_ring_kernel_refuses_head_dim_by_name():
    _need_cuda()
    x = torch.zeros(2, 8, 32, device="cuda")
    c = torch.zeros(2, 8, 1, device="cuda")
    with pytest.raises(ValueError, match="head_dim 32 not in"):
        rp.ring_step(x, x, x, c, c, x, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_paged_decode_gqa_at_llama_shape(pool):
    """Llama-300M's decode step: 8 rows, 16 query heads over 8 KV heads
    (num_rep = 2), D = 64, 64 pages of 16 per row, cursors up to 1023 (two
    idle rows on the null block 0, live rows on shuffled blocks), bf16 q
    over a bf16 pool or an int8 pool with f32 scales."""
    from distributeddeeplearning_tpu_torch.ops import paged_attention as pa

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    B, kvh, rep, D, bs, pages = 8, 8, 2, 64, 16, 64
    lens = [0, 37, 255, 256, 511, 700, 0, 1023]
    nb = 1 + B * pages
    shape = (nb, bs, kvh, D)
    q = torch.randn(B, kvh * rep, D, generator=g, device="cuda").to(
        torch.bfloat16)
    sk = sv = None
    if pool == "int8":
        pk, pv = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in "kv")
        sk, sv = (torch.rand(shape[:3], generator=g, device="cuda") / 127
                  for _ in "kv")
    else:
        pk, pv = (torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16) for _ in "kv")
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    table = torch.zeros(B, pages, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(lens):
        if n:
            table[b, :n // bs + 1] = perm[used:used + n // bs + 1].int()
            used += n // bs + 1
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, pk, pv, table, seq_lens)
    before = dict(pa.LAUNCHES)
    out = pa.paged_attention(*args, num_rep=rep, scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    kernel = "paged_decode_q8" if pool == "int8" else "paged_decode"
    assert pa.LAUNCHES[kernel] == before[kernel] + 1
    ref = pa.paged_attention_plain(*args, num_rep=rep, scale_k=sk,
                                   scale_v=sv)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
