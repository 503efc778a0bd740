"""The port's ring attention against the JAX package's, on the CPU.

- The plain ring (``ops.ring_attention``) and the fused ring
  (``ops.ring_attention_pallas``, its kernels' plain versions standing in
  for the CUDA kernels) against JAX's ``ring_attention`` and
  ``ring_attention_pallas`` (Pallas in interpret mode) on a cp=4 mesh of
  virtual CPU devices: forward and gradients, causal and full. The port
  side runs 4 virtual ranks in lockstep in one process: one thread per
  rank, whose ring shifts meet at a barrier (``torch_sharded.LockstepComm``,
  the transport ``comms.py`` calls in place of torch.distributed).
- Each ``*_plain`` kernel against the matching JAX Pallas kernel in
  interpret mode, mode 0 and mode 1.
- The bf16 tensor-core kernels' roundings, emulated in plain torch, against
  the plain versions: they stay inside the tolerances the card's checks
  hold those kernels to.

Tolerances against JAX are those of ``tests/test_context_parallel.py``:
rtol 2e-4, atol 2e-5 (fp32 throughout; only the order of the sums differs).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import ring_attention as jax_ring
from distributeddeeplearning_tpu.ops import (
    ring_attention_pallas as jax_ring_pallas,
)
from distributeddeeplearning_tpu_torch import comms
from distributeddeeplearning_tpu_torch.mesh import Mesh
from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas as rp
from distributeddeeplearning_tpu_torch.parallel.sp_ring import (
    check_ring_shapes,
    ring_attention_fn,
)

from helpers import mesh_of
from torch_sharded import lockstep

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
CP = 4
JAX_RP = importlib.import_module(
    "distributeddeeplearning_tpu.ops.ring_attention_pallas")


def make_qkv(b=2, l=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def _jax_run(impl, q, k, v, causal):
    """JAX's ring on the cp=4 mesh: the output and the gradients of
    sum(out ** 2)."""
    mesh = mesh_of(cp=CP)
    fn = {"ring": jax_ring, "ring_pallas": jax_ring_pallas}[impl]

    def loss(q, k, v):
        out = fn(q, k, v, mesh, causal=causal)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_run(impl, q, k, v, causal):
    """The port's ring on CP lockstep ranks, each holding its block of the
    sequence; the blocks joined back."""
    l = q.shape[1] // CP

    def rank(mesh):
        r = mesh.coords["cp"]
        qs, ks, vs = (torch.from_numpy(x[:, r * l:(r + 1) * l].copy())
                      .requires_grad_() for x in (q, k, v))
        out = ring_attention_fn(impl)(qs, ks, vs, mesh, causal=causal)
        grads = torch.autograd.grad((out ** 2).sum(), (qs, ks, vs))
        return out.detach(), grads

    res = lockstep(CP, rank, cp=CP)
    out = torch.cat([o for o, _ in res], dim=1).numpy()
    grads = [torch.cat([g[i] for _, g in res], dim=1).numpy()
             for i in range(3)]
    return out, grads


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_forward_matches_jax(impl, causal):
    q, k, v = make_qkv()
    out_j, _ = _jax_run(impl, q, k, v, causal)
    out_p, _ = _port_run(impl, q, k, v, causal)
    np.testing.assert_allclose(out_p, out_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_gradients_match_jax(impl, causal):
    q, k, v = make_qkv(seed=1)
    _, g_j = _jax_run(impl, q, k, v, causal)
    _, g_p = _port_run(impl, q, k, v, causal)
    for name, a, b in zip("qkv", g_p, g_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


def test_kernel_route_launches_nothing_on_the_cpu():
    """The plain versions stand in on CPU tensors: no launch is counted."""
    rp.reset_launches()
    q, k, v = make_qkv()
    _port_run("ring_pallas", q, k, v, True)
    assert rp.LAUNCHES == {"ring_step": 0, "ring_dq": 0, "ring_dkv": 0}


def _carries(rng, bh, L, d):
    m = rng.standard_normal((bh, L, 1)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (bh, L, 1)).astype(np.float32)
    acc = rng.standard_normal((bh, L, d)).astype(np.float32)
    return m, l, acc


@pytest.mark.parametrize("mode", [0, 1])
def test_ring_step_plain_matches_pallas_kernel(mode):
    rng = np.random.default_rng(2 + mode)
    bh, L, d = 6, 32, 16
    qf, kt, vt = (rng.standard_normal((bh, L, d)).astype(np.float32)
                  for _ in range(3))
    m, l, acc = _carries(rng, bh, L, d)
    want = JAX_RP._ring_step(qf, kt, vt, m, l, acc,
                             jnp.full((1, 1), mode, jnp.int32), block_q=16,
                             block_k=16, interpret=True)
    got = rp.ring_step_plain(*(torch.from_numpy(x) for x in
                               (qf, kt, vt, m, l, acc)), mode)
    for name, a, b in zip(("m", "l", "acc"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kernel", ["ring_dq", "ring_dkv"])
@pytest.mark.parametrize("mode", [0, 1])
def test_backward_plain_matches_pallas_kernels(kernel, mode):
    """``_ring_bwd_step`` runs the JAX dq and dk/dv kernels on one visit;
    lse and delta come from a forward over the same block so that p is a
    softmax."""
    rng = np.random.default_rng(4 + mode)
    bh, L, d = 6, 32, 16
    scale = 1.0 / np.sqrt(d)
    q, kt, vt, do = (rng.standard_normal((bh, L, d)).astype(np.float32)
                     for _ in range(4))
    s = np.einsum("bqd,bkd->bqk", q * scale, kt)
    if mode:
        s = np.where(np.tril(np.ones((L, L), bool)), s, -1e30)
    lse = (s.max(-1, keepdims=True) + np.log(np.exp(
        s - s.max(-1, keepdims=True)).sum(-1, keepdims=True)))
    delta = rng.standard_normal((bh, L, 1)).astype(np.float32)
    dq, dk, dv = (rng.standard_normal((bh, L, d)).astype(np.float32)
                  for _ in range(3))
    lse = lse.astype(np.float32)
    want = JAX_RP._ring_bwd_step(
        q, kt, vt, do, lse, delta, dq, dk, dv,
        jnp.full((1, 1), mode, jnp.int32), sm_scale=float(scale),
        block_q=16, block_k=16, interpret=True)
    t = {n: torch.from_numpy(x) for n, x in dict(
        q=q, kt=kt, vt=vt, do=do, lse=lse, delta=delta, dq=dq, dk=dk,
        dv=dv).items()}
    args = (t["q"], t["kt"], t["vt"], t["do"], t["lse"], t["delta"])
    if kernel == "ring_dq":
        got = [rp.ring_dq_plain(*args, t["dq"], mode, float(scale))]
        want = want[:1]
    else:
        got = rp.ring_dkv_plain(*args, t["dk"], t["dv"], mode, float(scale))
        want = want[1:]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


# The bf16 ring kernels run on the tensor cores. ring_dkv rounds P and dS
# to bf16 inside its products, as the flash kernels do, and is held to its
# plain version on the card at 2e-2 + 2e-2 |ref|. ring_step feeds P V with
# P as two bf16 terms, and at D = 128 qf too (the scale is no power of two
# there), because its acc carry is not normalised; ring_dq feeds dS K with
# dS as two bf16 terms, because one misses its dq carry's tolerance: both
# are held at the fp32 design's 2e-3. The emulations below round where the
# kernels round, in plain torch, and show that each tolerance covers them.
DKV_TOL, STEP_TOL, DQ_TOL = 2e-2, 2e-3, 2e-3


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16_split(x):
    """x as the sum of two bf16 terms: the kernels' SPLIT_Q and SPLIT_P."""
    return _bf16(x) + _bf16(x - _bf16(x))


def _ring_step_tc_emulated(qf, kt, vt, m, l, acc, mode, p_terms=2):
    """ring_step as the tensor-core kernel computes it: qf into the Q tile
    as one bf16 term at D = 64 and two at D = 128, P into P V as
    ``p_terms`` bf16 terms (rounded relative to the block's row max; the
    kernel's running max gives a rounding of the same relative size), and
    the block's state from an empty start merged into the carries at the
    end."""
    d = qf.shape[-1]
    s = rp._scores(_bf16(qf) if d == 64 else _bf16_split(qf), kt, mode)
    m_b = s.amax(-1, keepdim=True)
    p = torch.exp(s - m_b)
    pv = _bf16(p) if p_terms == 1 else _bf16_split(p)
    acc_b = torch.einsum("bqk,bkd->bqd", pv, vt.float())
    m_new = torch.maximum(m, m_b)
    a, b = torch.exp(m - m_new), torch.exp(m_b - m_new)
    return m_new, l * a + p.sum(-1, keepdim=True) * b, acc * a + acc_b * b


def _ring_dkv_tc_emulated(q, kt, vt, do, lse, delta, dk, dv, mode,
                          sm_scale):
    """ring_dkv as the tensor-core kernel computes it: P rounded to bf16
    inside P^T dO and dS inside dS^T Q."""
    p, ds = rp._p_ds(q, kt, vt, do, lse, delta, mode, sm_scale)
    return (dk + sm_scale * torch.einsum("bqk,bqd->bkd", _bf16(ds),
                                         q.float()),
            dv + torch.einsum("bqk,bqd->bkd", _bf16(p), do.float()))


def _ring_dq_tc_emulated(q, kt, vt, do, lse, delta, dq, mode, sm_scale,
                         ds_terms=2):
    """ring_dq as the tensor-core kernel computes it: dS into dS K as
    ``ds_terms`` bf16 terms, the sum added to the carry once."""
    _, ds = rp._p_ds(q, kt, vt, do, lse, delta, mode, sm_scale)
    dsk = _bf16(ds) if ds_terms == 1 else _bf16_split(ds)
    return dq + sm_scale * torch.einsum("bqk,bkd->bqd", dsk, kt.float())


def _bf16_visit(d, mode, seed, bh=4, L=96):
    """One visit's inputs as the cp path feeds the kernels: bf16 q, k, v,
    dO (drawn standard normal, as the card's checks draw them), qf = scale
    q in fp32, fp32 carries, lse of the block itself."""
    rng = np.random.default_rng(seed)
    scale = d ** -0.5
    q, kt, vt, do = (torch.from_numpy(rng.standard_normal((bh, L, d))
                                      .astype(np.float32)).to(torch.bfloat16)
                     for _ in range(4))
    m, l, acc = (torch.from_numpy(x) for x in _carries(rng, bh, L, d))
    qf = q.float() * scale
    lse = torch.logsumexp(rp._scores(qf, kt, mode), -1, keepdim=True)
    delta, dk, dv, dq = (torch.from_numpy(rng.standard_normal(shape)
                                          .astype(np.float32))
                         for shape in ((bh, L, 1), (bh, L, d), (bh, L, d),
                                       (bh, L, d)))
    return dict(q=q, qf=qf, kt=kt, vt=vt, do=do, m=m, l=l, acc=acc, lse=lse,
                delta=delta, dk=dk, dv=dv, dq=dq, scale=scale)


def _tolerance_used(a, b, tol):
    return ((a - b).abs() / (tol + tol * b.abs())).max().item()


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("mode", [0, 1])
def test_tensor_core_roundings_stay_inside_the_tolerances(mode, head_dim):
    x = _bf16_visit(head_dim, mode, seed=7 + mode)
    carries = (x["m"], x["l"], x["acc"])
    bwd = (x["q"], x["kt"], x["vt"], x["do"], x["lse"], x["delta"], x["dk"],
           x["dv"], mode, x["scale"])
    dq_args = (x["q"], x["kt"], x["vt"], x["do"], x["lse"], x["delta"],
               x["dq"], mode, x["scale"])
    got = {"step": _ring_step_tc_emulated(x["qf"], x["kt"], x["vt"],
                                          *carries, mode),
           "dq": (_ring_dq_tc_emulated(*dq_args),),
           "dkv": _ring_dkv_tc_emulated(*bwd)}
    want = {"step": rp.ring_step_plain(x["qf"], x["kt"], x["vt"], *carries,
                                       mode),
            "dq": (rp.ring_dq_plain(*dq_args),),
            "dkv": rp.ring_dkv_plain(*bwd)}
    for kernel, names, tol in (("step", ("m", "l", "acc"), STEP_TOL),
                               ("dq", ("dq",), DQ_TOL),
                               ("dkv", ("dk", "dv"), DKV_TOL)):
        for name, a, b in zip(names, got[kernel], want[kernel]):
            used = _tolerance_used(a, b, tol)
            assert used <= 1, f"{name}: {used:.3f} of the tolerance"
    # The roundings move ring_dq's and ring_dkv's outputs: the check is not
    # vacuous.
    assert not torch.equal(got["dq"][0], want["dq"][0])
    assert not torch.equal(got["dkv"][0], want["dkv"][0])
    assert not torch.equal(got["dkv"][1], want["dkv"][1])


@pytest.mark.parametrize("head_dim", [64, 128])
def test_one_bf16_term_of_ds_would_break_the_dq_carry_tolerance(head_dim):
    """Why ring_dq splits dS: on the diagonal block (mode 1), dS rounded to
    bf16 inside dS K (flash_dq's rounding) leaves the dq carry outside
    2e-3 + 2e-3 |ref|; two terms stay far inside it."""
    x = _bf16_visit(head_dim, 1, seed=8)
    args = (x["q"], x["kt"], x["vt"], x["do"], x["lse"], x["delta"], x["dq"],
            1, x["scale"])
    want = rp.ring_dq_plain(*args)
    assert _tolerance_used(_ring_dq_tc_emulated(*args, ds_terms=1), want,
                           DQ_TOL) > 1
    assert _tolerance_used(_ring_dq_tc_emulated(*args, ds_terms=2), want,
                           DQ_TOL) < 0.1


def test_one_bf16_term_of_p_would_break_the_acc_carry_tolerance():
    """Why ring_step splits P: at the cp=2 training shape's L and D, P
    rounded to bf16 inside P V (the flash forward's rounding) leaves the
    unnormalised acc carry beyond even 2e-2 + 2e-2 |ref|; two terms stay far
    inside the fp32 design's 2e-3."""
    x = _bf16_visit(64, 0, seed=11, bh=8, L=512)
    args = (x["qf"], x["kt"], x["vt"], x["m"], x["l"], x["acc"], 0)
    want = rp.ring_step_plain(*args)[2]
    one = _ring_step_tc_emulated(*args, p_terms=1)[2]
    two = _ring_step_tc_emulated(*args, p_terms=2)[2]
    assert _tolerance_used(one, want, 2e-2) > 1
    assert _tolerance_used(two, want, STEP_TOL) < 0.1


def test_qf_rounding_is_exact_at_head_dim_64():
    """At D = 64 the scale is 2^-3: a bf16 q times it is a bf16 number, so
    the kernel's one bf16 Q tile holds qf exactly; at D = 128 it does not,
    and two bf16 terms hold it to ~2^-16."""
    for d, exact in ((64, True), (128, False)):
        qf = _bf16_visit(d, 0, seed=3)["qf"]
        assert torch.equal(_bf16(qf), qf) == exact
        err = (_bf16_split(qf) - qf).abs().max().item()
        assert err <= 2.0 ** -16 * qf.abs().max().item()


def test_ring_shapes_and_impls_are_checked():
    check_ring_shapes(32, 4)
    with pytest.raises(ValueError, match="not divisible by cp=3"):
        check_ring_shapes(32, 3)
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring_attention_fn("ulysses")
    with pytest.raises(ValueError, match="has no transport"):
        comms.ring_shift([torch.zeros(2)], Mesh({"cp": 2}), "cp", shift=-1)


def test_lockstep_ring_shift_and_its_transpose():
    """shift=-1 receives from the +1 neighbour; the backward sends each
    cotangent back to where its tensor came from."""

    def rank(mesh):
        r = mesh.coords["cp"]
        x = torch.full((3,), float(r), requires_grad=True)
        (y,) = comms.ring_shift([x], mesh, "cp", shift=-1)
        (g,) = torch.autograd.grad((y * (10.0 + r)).sum(), (x,))
        return y.detach(), g

    res = lockstep(CP, rank, cp=CP)
    for r, (y, g) in enumerate(res):
        assert torch.equal(y, torch.full((3,), float((r + 1) % CP)))
        # x of rank r went to rank r - 1, which weighs it by 10 + (r - 1).
        assert torch.equal(g, torch.full((3,), 10.0 + (r - 1) % CP))


def test_lockstep_psum_and_pmean():
    def rank(mesh):
        x = torch.tensor([float(mesh.rank), 1.0])
        return comms.psum(x, mesh), comms.pmean(x, mesh, "cp")

    for s, m in lockstep(CP, rank, cp=CP):
        assert torch.equal(s, torch.tensor([6.0, 4.0]))
        assert torch.equal(m, torch.tensor([1.5, 1.0]))
