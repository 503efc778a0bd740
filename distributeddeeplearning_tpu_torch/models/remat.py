"""Per-block activation checkpointing (remat): the JAX package's
``nn.remat(block_cls, policy=...)``.

- ``'full'``: ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
  a block keeps its inputs only, and the backward runs it again;
- ``'dots'``: ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
  through ``create_selective_checkpoint_contexts``: the outputs of matrix
  products without batch dims are saved, everything else is recomputed.
  ``F.linear`` dispatches ``aten.mm``/``aten.addmm``; an einsum without
  batch dims dispatches ``aten.bmm`` over a batch of one, so the policy
  reads the shape as well as the name. Attention's batched products
  (``bmm`` over batch x heads) are recomputed, as JAX's are.

State outside the checkpointed function would be wrong on a recompute:

- dropout draws from an explicit ``torch.Generator``, which
  ``torch.utils.checkpoint`` does not restore (it restores the global RNG
  states only): :func:`checkpoint_block` snapshots the generator before the
  block and replays it for the recompute, so the recompute draws the
  forward's masks, then puts the generator back where it was;
- in-place side effects of a training forward (BatchNorm's running
  statistics): :func:`recomputing` is True while a block is recomputed,
  and such a module skips them there, as JAX's recompute, which returns
  the statistics as an output, changes nothing;
- the block's parameters: a mixed-precision step calls the model on its
  compute copies (``torch.func.functional_call``), which are swapped back
  for the fp32 masters before the backward recomputes. The block's
  parameters at its forward are kept and put in place for the recompute,
  so the recompute runs the forward's ops on the forward's tensors (under
  'dots' the policy matches the two op for op; under 'full' the masters'
  casts would only repeat the copies' values).

The hand kernels launch through ctypes, which the policy's dispatch mode
does not see: under either policy a block's flash forward runs again in
the recompute, as a ``pallas_call`` (no saveable dot) does under JAX's.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_MODES = ("none", "full", "dots")

_LOCAL = threading.local()


def recomputing() -> bool:
    """True while this thread recomputes a checkpointed block."""
    return getattr(_LOCAL, "depth", 0) > 0


def check_remat(remat: str) -> str:
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    return remat


def _dots_policy(ctx, op, *args, **kwargs):
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    if op is aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _parameters_of(module, params: dict):
    """``module``'s parameters set to ``params`` (by name) for the scope,
    then put back."""
    swapped = []
    for name, t in params.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        swapped.append((owner, leaf, owner._parameters[leaf]))
        owner._parameters[leaf] = t
    try:
        yield
    finally:
        for owner, leaf, t in swapped:
            owner._parameters[leaf] = t


def checkpoint_block(fn, *args, remat: str, generator=None, module=None):
    """``fn(*args)`` under ``remat`` ('none', or no gradient to take,
    calls it as it is). The tensors of ``args`` are the block's
    checkpointed inputs; ``generator`` is the dropout generator ``fn``
    draws from, if any; ``module`` the block whose parameters ``fn`` uses
    (recomputed on the tensors its forward used)."""
    if check_remat(remat) == "none" or not torch.is_grad_enabled():
        return fn(*args)
    snapshot = None if generator is None else generator.get_state()
    params = {} if module is None else dict(module.named_parameters())
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:  # the forward
            return fn(*a)
        resume = None
        if snapshot is not None:
            resume = generator.get_state()
            generator.set_state(snapshot)
        _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
        try:
            with _parameters_of(module, params):
                return fn(*a)
        finally:
            _LOCAL.depth -= 1
            if resume is not None:
                generator.set_state(resume)

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(run, *args, use_reentrant=False, **kw)
