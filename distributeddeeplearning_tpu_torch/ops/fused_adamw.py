"""Fused AdamW update: the optimizer step of ``optim.name='adamw_fused'``.

:class:`FusedAdamW` keeps the reference's semantics (``fused_adamw`` of the
JAX package): the :func:`decay_leaf` mask, the global-norm clip inside the
update, optax's schedule convention (lr at the pre-increment count, bias
corrections at the post-increment one), and the split at
``_MIN_KERNEL_SIZE``: leaves smaller than that take the plain path, and the
kernel-sized leaves are grouped by (dtype, weight decay), one kernel launch
per group.

Under ZeRO-1 (``parallel/zero.py``) :meth:`FusedAdamW.update_shard` updates
one rank's flat shard of each decay group, one launch a group, its weight
decay the group's; the clip scales by the global norm the ranks computed
together.

:func:`fused_adamw_group` launches the kernel of ``csrc/fused_adamw.cu`` on
CUDA tensors, over a device table of the group's leaves, and updates p, m
and v IN PLACE (the reference's buffers are donated step-local copies; the
port has no such copies to make). On CPU tensors it runs
:func:`fused_adamw_plain`, the same arithmetic in plain torch, one rounding
per operation as the kernel does, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..debug import check_nans

_MIN_KERNEL_SIZE = 1024  # the reference's 8 x 128 fp32 tile; below it, plain
_THREADS = 256

# Kernel launches by the wrapper. Only a launch adds to it.
LAUNCHES = {"fused_adamw": 0}


def reset_launches() -> None:
    LAUNCHES["fused_adamw"] = 0


def decay_leaf(p) -> bool:
    """THE weight-decay rule: matrices and embeddings (ndim >= 2) decay;
    biases and norm scales (ndim < 2) do not."""
    return p.ndim >= 2


class FusedAdamWState(NamedTuple):
    count: int  # completed updates
    mu: dict  # name -> fp32 first moment, params-shaped
    nu: dict  # name -> fp32 second moment


def f32(x) -> float:
    """A host scalar rounded to fp32, as the reference's weakly typed Python
    floats become fp32 constants (and as the kernel receives them)."""
    return float(np.float32(x))


def bias_corrections(b1: float, b2: float, count: int) -> tuple[float, float]:
    """c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) in fp32 at t = count."""
    t, one = np.float32(count), np.float32(1.0)
    c1 = one / (one - np.power(np.float32(b1), t))
    c2 = one / (one - np.power(np.float32(b2), t))
    return float(c1), float(c2)


def _hyper(lr, b1, b2, eps, wd, c1, c2) -> dict:
    return dict(lr=f32(lr), b1=f32(b1), omb1=f32(1.0 - b1), b2=f32(b2),
                omb2=f32(1.0 - b2), c1=f32(c1), c2=f32(c2), eps=f32(eps),
                wd=f32(wd))


@torch.no_grad()
def fused_adamw_plain(p, g, m, v, *, lr, b1, b2, eps, wd, c1, c2) -> None:
    """The update of one flat (or any-shaped) fp32 group, in place on p, m,
    v, one rounding per operation in the kernel's order."""
    h = _hyper(lr, b1, b2, eps, wd, c1, c2)
    g = g.float()
    m.mul_(h["b1"]).add_(g * h["omb1"])
    v.mul_(h["b2"]).add_((g * h["omb2"]) * g)
    mhat, vhat = m * h["c1"], v * h["c2"]
    u = mhat / (vhat.sqrt() + h["eps"]) + p * h["wd"]
    p.add_(u * -h["lr"])


def fused_adamw_group(ps, gs, ms, vs, *, lr, b1, b2, eps, wd, c1,
                      c2) -> None:
    """One (dtype, decay) group of leaves, updated in place: one kernel
    launch for CUDA tensors, the plain version leaf by leaf for CPU
    tensors."""
    if not ps:
        return
    dev = ps[0].device
    if dev.type == "cpu":
        for p, g, m, v in zip(ps, gs, ms, vs):
            fused_adamw_plain(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                              wd=wd, c1=c1, c2=c2)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: no kernel for device {dev}")
    gs = [g.contiguous() for g in gs]
    for i, leaf in enumerate(zip(ps, gs, ms, vs)):
        for name, t in zip("pgmv", leaf):
            if t.device != dev or t.dtype != torch.float32:
                raise TypeError(
                    f"fused_adamw kernel: leaf {i} {name} is {t.dtype} on "
                    f"{t.device}, expected float32 on {dev}"
                )
            if not t.is_contiguous():
                raise ValueError(f"fused_adamw kernel: leaf {i} {name} must "
                                 "be contiguous (updated in place)")
            if t.numel() != leaf[0].numel():
                raise ValueError(f"fused_adamw kernel: leaf {i} {name} has "
                                 f"{t.numel()} elements, p {leaf[0].numel()}")
    from ._build import load

    lib = _bind(load("fused_adamw"))
    table = torch.tensor(
        [[t.data_ptr() for t in ts] for ts in (ps, gs, ms, vs)]
        + [[p.numel() for p in ps]], dtype=torch.int64,
    ).pin_memory().to(dev, non_blocking=True)
    total = sum(p.numel() for p in ps)
    blocks = max(1, min(-(-total // (_THREADS * 4)), 132 * 16))
    h = _hyper(lr, b1, b2, eps, wd, c1, c2)
    err = lib.ddl_fused_adamw(
        table.data_ptr(), len(ps), blocks, h["lr"], h["b1"], h["omb1"],
        h["b2"], h["omb2"], h["c1"], h["c2"], h["eps"], h["wd"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "fused_adamw kernel launch failed: "
            f"{lib.ddl_cuda_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES["fused_adamw"] += 1
    check_nans("fused_adamw", *ps, *ms, *vs)


def _bind(lib):
    if getattr(lib, "_ddl_bound", False):
        return lib
    vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ddl_fused_adamw.argtypes = [vp, i32, i32] + [f] * 9 + [vp]
    lib.ddl_fused_adamw.restype = i32
    lib.ddl_cuda_error_string.argtypes = [i32]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    lib._ddl_bound = True
    return lib


def stochastic_round(x: torch.Tensor, bits: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding: round up with probability
    proportional to the distance to the next representable value.

    bf16 is fp32's top 16 bits, so adding uniform random low-16 bits to the
    fp32 bit pattern and truncating rounds each value up with probability
    ``low_bits / 2^16``: unbiased in expectation, so a moment EMA keeps the
    contributions below one bf16 ulp that round-to-nearest would drop.

    ``bits`` (integers, ``x``'s shape) supply the randomness; only their low
    16 bits are used. The reference draws them from a JAX key; torch cannot
    replay that key chain, so they are an input here (the CPU tests feed
    the reference's own bits and compare bit for bit). Non-finite values
    bypass the add (a carry would walk inf into nan space) and cast
    directly. Not a Pallas kernel in the reference: plain torch."""
    if dtype != torch.bfloat16:
        raise NotImplementedError(
            f"stochastic_round targets bfloat16 (got {dtype}): the "
            "truncation trick needs the target to be the source's high bits"
        )
    x = x.float()
    noise = bits.to(torch.int32) & 0xFFFF
    # A finite fp32 pattern plus < 2^16 never crosses the int32 sign or
    # overflow boundary (only the nan patterns lie there), so the int32
    # sum equals the reference's uint32 one.
    rounded = (x.view(torch.int32) + noise) & -0x10000
    out = rounded.view(torch.float32).to(torch.bfloat16)
    return torch.where(torch.isfinite(x), out, x.to(torch.bfloat16))


def global_norm(grads: dict):
    """sqrt of the sum of squares over every leaf, fp32, on the device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads.values()]))


@torch.no_grad()
def clip_by_global_norm(grads: dict, clip: float, norm=None) -> dict:
    """The reference's ``_clip_by_global_norm``: g * clip / max(norm,
    clip), ``norm`` the global norm of ``grads`` unless given (a ZeRO-1
    rank's shards are not the whole gradient). Returns new tensors."""
    norm = global_norm(grads) if norm is None else norm
    scale = clip / torch.clamp(norm, min=clip)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


def split_leaves(params: dict, weight_decay: float):
    """(plain leaves [(name, wd)], kernel groups {(dtype, wd): [names]}),
    the reference's split: leaves under ``_MIN_KERNEL_SIZE`` elements go
    plain; the rest group by (dtype, decay)."""
    plain, groups = [], {}
    for name, p in params.items():
        wd = weight_decay if decay_leaf(p) else 0.0
        if p.numel() < _MIN_KERNEL_SIZE:
            plain.append((name, wd))
        else:
            groups.setdefault((p.dtype, wd), []).append(name)
    return plain, groups


class FusedAdamW:
    """AdamW whose update of the kernel-sized leaves is the fused kernel.

    ``init(params)`` makes the state; ``update(grads, state, params)``
    updates ``params`` and the state's moments in place and returns the
    state with the count advanced. ``learning_rate`` is a float or a
    schedule ``count -> lr``."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 grad_clip: float = 0.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> FusedAdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}

        return FusedAdamWState(count=0, mu=zeros(), nu=zeros())

    def init_shard(self, layout):
        """The state of one ZeRO-1 rank (``parallel.zero.ZeroState``): its
        shard of each group's moments, zeros."""
        from ..parallel.zero import ZeroState

        def zeros():
            return {g: f.new_zeros(layout.shard_size[g])
                    for g, f in layout.flats.items()}

        return ZeroState(count=0, mu=zeros(), nu=zeros(), layout=layout)

    def _hyper(self, count: int) -> dict:
        """The update's hyperparameters at the pre-increment ``count``."""
        lr = (self.learning_rate(count)
              if callable(self.learning_rate) else self.learning_rate)
        c1, c2 = bias_corrections(self.b1, self.b2, count + 1)
        return dict(lr=lr, b1=self.b1, b2=self.b2, eps=self.eps, c1=c1,
                    c2=c2)

    @torch.no_grad()
    def update_shard(self, grads: dict, state, params: dict, norm):
        """One ZeRO-1 rank's update: ``grads`` and ``params`` map each group
        (``parallel.zero.GROUPS``) to this rank's flat shard, ``norm`` is
        the global gradient norm. The clip scales every shard by the global
        norm; each group is one kernel launch (a table of one entry), its
        weight decay the group's. Updates ``params`` and the moments in
        place and returns the state with the count advanced."""
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        hp = self._hyper(state.count)
        for g, p in params.items():
            wd = self.weight_decay if g == "decay" else 0.0
            fused_adamw_group([p], [grads[g]], [state.mu[g]], [state.nu[g]],
                              wd=wd, **hp)
        return state._replace(count=state.count + 1)

    @torch.no_grad()
    def update(self, grads: dict, state: FusedAdamWState, params: dict,
               norm=None) -> FusedAdamWState:
        """``norm``: the global gradient norm when ``grads`` are not the
        whole model's (a pipeline stage's); else computed from them."""
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        count = state.count + 1
        hp = self._hyper(state.count)
        plain, groups = split_leaves(params, self.weight_decay)
        for name, wd in plain:
            fused_adamw_plain(params[name], grads[name], state.mu[name],
                              state.nu[name], wd=wd, **hp)
        for (_, wd), names in groups.items():
            fused_adamw_group(
                [params[n] for n in names], [grads[n] for n in names],
                [state.mu[n] for n in names], [state.nu[n] for n in names],
                wd=wd, **hp,
            )
        return FusedAdamWState(count=count, mu=state.mu, nu=state.nu)
