"""The Trainer's two debug switches: ``train.debug_nans`` and
``train.debug_checks`` (the reference's ``jax_debug_nans`` and
``jax_enable_checks``, which ``cli train`` turns on for its run).

- :func:`nan_checks`: while on, every floating output of a torch op this
  thread runs (and the autograd engine runs for it, the backward included)
  is checked, and the first that holds a NaN raises ``FloatingPointError``
  naming the op (:class:`NanCheckMode`). The hand kernels launch outside
  torch's dispatcher, so each kernel wrapper checks its own outputs with
  :func:`check_nans` under the same switch. A NaN literal (a 0-d
  constant, such as the poison value of a masked attention row) is not a
  computed value and is not checked, as the reference folds such
  constants into its programs.
- :func:`bounds_checks`: while on, ``models.transformer.
  paged_decode_attention`` poisons to NaN every row whose page table holds
  an entry outside ``[0, num_blocks)``, after pointing that row at the
  null block so neither the pool writes nor the paged kernel read outside
  the pool (the reference's out-of-bounds tripwire).

Both are off unless a context turns them on; off, each hook costs one
truthiness check.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Process-wide, as the reference's config flags are: the autograd engine
# runs a CUDA backward (and its kernel wrappers) on threads of its own.
_ON = {"nans": False, "checks": False}

_aten = torch.ops.aten
# Ops whose outputs are no computed values: allocations (whose memory a
# kernel fills afterwards), copies (a non-blocking copy's destination is
# read only after its event), detaches.
_UNCHECKED = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._to_copy, _aten.copy_, _aten.detach,
    _aten.set_, _aten.resize_,
})
# Ops that make a constant: checked unless 0-d (a NaN literal).
_LITERALS = frozenset({_aten.full, _aten.scalar_tensor, _aten.lift_fresh,
                       _aten.lift_fresh_copy})


def nans_on() -> bool:
    return _ON["nans"]


def checks_on() -> bool:
    return _ON["checks"]


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


def check_nans(where: str, *tensors) -> None:
    """Under :func:`nan_checks`, raise ``FloatingPointError`` naming
    ``where`` (a kernel wrapper) when one of ``tensors`` holds a NaN."""
    if _ON["nans"] and any(_has_nan(t) for t in tensors):
        raise FloatingPointError(f"invalid value (nan) encountered in {where}")


class NanCheckMode(TorchDispatchMode):
    """Runs each op, then raises ``FloatingPointError`` naming it when one
    of its floating outputs holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if (packet in _UNCHECKED or func.is_view
                or func.namespace not in ("aten", "prims")):
            return out
        for t in tree_leaves(out):
            if packet in _LITERALS and isinstance(t, torch.Tensor) \
                    and t.dim() == 0:
                continue
            if _has_nan(t):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_checks(on: bool = True):
    """``train.debug_nans``: NaN checks on every op and kernel for the
    length of the context (nothing at all when ``on`` is false)."""
    if not on:
        yield
        return
    before = _ON["nans"]
    _ON["nans"] = True
    try:
        with NanCheckMode():
            yield
    finally:
        _ON["nans"] = before


@contextlib.contextmanager
def bounds_checks(on: bool = True):
    """``train.debug_checks``: the paged attention's page-table tripwire
    for the length of the context."""
    before = _ON["checks"]
    _ON["checks"] = before or bool(on)
    try:
        yield
    finally:
        _ON["checks"] = before
