"""int8 weight-quantized serving (``serving.quant='int8'``).

The block codec of ``comms_quant`` (int8 values and one f32 scale per
block, max-abs -> ±127) quantizes the weights once at engine build, on the
device the model lives on. Each eligible parameter of the model is
replaced, under its own name, by a :class:`QuantizedLeaf` holding ``q``
(int8 ``[n, block]``), ``scale`` (f32 ``[n, 1]``) and what rebuilds the
float leaf (``shape``, ``size``, ``dtype``), so the resident weights are
~4x smaller. A module reads its leaves through ``parallel.fsdp.full_param``,
which dequantizes a ``QuantizedLeaf`` where it is used: one leaf's float
copy lives for the product that reads it, never the whole float model.

The same leaves as the JAX package's ``serving/quant.py`` are quantized:
float, ``ndim >= 2`` and at least one block (embeddings, projections, MLP
kernels); biases and norm scales stay float. The port keeps the JAX
layouts and names, so each leaf's ravel, and its ``q`` and ``scale``,
equal the reference's bit for bit (``block_quantize`` divides, as eager
JAX does). Quantized serving is fenced to the dense decode models at
config time (``engine.check_serving_composition``), as in JAX.
"""

from __future__ import annotations

import torch

from ..comms_quant import _pad_to, block_dequantize, block_quantize


class QuantizedLeaf:
    """One block-quantized parameter: the codes and scales on the device,
    and the float leaf's shape, element count and dtype."""

    def __init__(self, q, scale, shape, size, dtype):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.size = int(size)
        self.dtype = dtype

    def dequantize(self) -> torch.Tensor:
        """The float leaf, rebuilt from the codes."""
        flat = block_dequantize(self.q, self.scale)
        return flat[: self.size].reshape(self.shape).to(self.dtype)

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __repr__(self):
        return f"QuantizedLeaf(shape={self.shape}, dtype={self.dtype})"


def _should_quantize(leaf: torch.Tensor, block_size: int) -> bool:
    return (leaf.is_floating_point() and leaf.dim() >= 2
            and leaf.numel() >= block_size)


def _encode(leaf: torch.Tensor, block_size: int):
    flat = _pad_to(leaf.detach().reshape(-1).to(torch.float32), block_size)
    q, scale = block_quantize(flat, block_size)
    return flat, q, scale


def quantize_params(model, block_size: int = 256) -> dict:
    """Quantize ``model``'s eligible parameters in place (once, on the
    model's device). Returns the report the engine's stats carry: the
    byte counts before and after, their ratio, and the largest relative
    L2 round-trip error over the quantized leaves."""
    orig_bytes = quant_bytes = 0
    worst = 0.0
    for name, leaf in list(model.named_parameters()):
        nbytes = leaf.numel() * leaf.element_size()
        orig_bytes += nbytes
        if not _should_quantize(leaf, block_size):
            quant_bytes += nbytes
            continue
        flat, q, scale = _encode(leaf, block_size)
        den = float(torch.linalg.vector_norm(flat))
        if den > 0:
            err = torch.linalg.vector_norm(block_dequantize(q, scale) - flat)
            worst = max(worst, float(err) / den)
        ql = QuantizedLeaf(q, scale, leaf.shape, leaf.numel(), leaf.dtype)
        quant_bytes += ql.nbytes
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        del module._parameters[attr]
        setattr(module, attr, ql)
    return {
        "block_size": block_size,
        "param_bytes_fp": int(orig_bytes),
        "param_bytes_quant": int(quant_bytes),
        "ratio": round(quant_bytes / max(orig_bytes, 1), 4),
        "max_rel_error": round(worst, 6),
    }


def quantized_leaves(model) -> dict[str, QuantizedLeaf]:
    """Every :class:`QuantizedLeaf` of ``model``, by its parameter name."""
    return {
        f"{prefix}{'.' if prefix else ''}{attr}": value
        for prefix, module in model.named_modules()
        for attr, value in vars(module).items()
        if isinstance(value, QuantizedLeaf)
    }


def dequantize_params(model) -> dict[str, torch.Tensor]:
    """``model``'s whole float state: its parameters as they are and every
    quantized leaf rebuilt — the weights an unquantized model loads to
    compute what the quantized one computes."""
    out = {name: p.detach() for name, p in model.named_parameters()}
    out.update({name: ql.dequantize()
                for name, ql in quantized_leaves(model).items()})
    return out


def resident_param_bytes(model) -> int:
    """Bytes of ``model``'s weights as they sit on the device: float
    parameters plus the codes and scales of the quantized leaves."""
    return sum(p.numel() * p.element_size() for p in model.parameters()) + sum(
        ql.nbytes for ql in quantized_leaves(model).values())

