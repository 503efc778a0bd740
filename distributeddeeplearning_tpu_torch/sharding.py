"""Where every parameter of a tensor-, fully- or expert-sharded model lives:
the counterpart of the JAX package's ``sharding.py``.

JAX attaches logical axis names to each parameter dimension and maps them
onto mesh axes with one rules table (``DEFAULT_LOGICAL_RULES``); XLA then
places the collectives. The port keeps the same two tables and reads them
once, here:

- :data:`LOGICAL_AXES`: each GPT-2, Llama and MoE leaf, by name, to its
  logical axes, copied from the JAX models' annotations
  (``models/transformer.py`` ``("embed", "heads", "kv")`` for the attention
  projections, ``("heads", "kv", "embed")`` for ``out``, ``("embed",
  "mlp")`` / ``("mlp", "embed")`` for the MLP, ``("vocab", "embed")`` for
  the embeddings, ``("embed", "vocab")`` for Llama's untied ``lm_head``,
  ``("norm",)`` for GPT-2's LayerNorms and ``("embed",)`` for Llama's
  RMSNorm scales; ``models/moe.py`` ``("embed", "expert")`` for the router,
  ``("expert", "embed", "mlp")`` / ``("expert", "mlp", "embed")`` for the
  experts' matrices, ``("expert", "mlp")`` / ``("expert", "embed")`` for
  their biases);
- :data:`DEFAULT_LOGICAL_RULES`: logical axis -> mesh axis (``embed`` over
  ``fsdp``; ``heads``, ``mlp`` and ``vocab`` over ``tp``; ``expert`` over
  ``ep``; the rest replicated), with :func:`validate_logical_spec`'s
  refusal of two dimensions of one leaf on one mesh axis.

:class:`ShardLayout` applies them to one model on one mesh: each leaf's
whole shape, the dimension each live axis (size > 1) cuts, and this rank's
block of it. A dimension of ``n`` over ``k`` ranks is cut into blocks of
``ceil(n / k)``; the last rank's block is padded with zeros where ``k``
does not divide ``n`` (GPT-2's vocabulary of 50257 over tp, as XLA pads
it). ``heads``, ``mlp`` and ``expert`` must divide: a padded head would be
a head (JAX's ``check_moe_shapes`` refuses experts that ``ep`` does not
divide).
"""

from __future__ import annotations

import math
import re

import torch

from . import comms

# Leaf name (a regular expression over the flattened parameter path) ->
# logical axes, first match wins.
LOGICAL_AXES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"(^|\.)(wte|embed)\.embedding$", ("vocab", "embed")),
    (r"(^|\.)wpe\.embedding$", ("pos", "embed")),
    (r"(^|\.)lm_head$", ("embed", "vocab")),
    (r"\.attn\.(query|key|value)\.kernel$", ("embed", "heads", "kv")),
    (r"\.attn\.(query|key|value)\.bias$", ("heads", "kv")),
    (r"\.attn\.out\.kernel$", ("heads", "kv", "embed")),
    (r"\.(attn\.out|mlp\.fc_out)\.bias$", ("embed",)),
    (r"\.mlp\.(fc_in|gate|up)\.kernel$", ("embed", "mlp")),
    (r"\.mlp\.fc_in\.bias$", ("mlp",)),
    (r"\.mlp\.(fc_out|down)\.kernel$", ("mlp", "embed")),
    (r"(^|\.)(ln1|ln2|ln_f)\.(scale|bias)$", ("norm",)),
    (r"(^|\.)(attn_norm|mlp_norm|norm)\.scale$", ("embed",)),
    (r"\.moe_mlp\.router\.kernel$", ("embed", "expert")),
    (r"\.moe_mlp\.(w1|w_gate)$", ("expert", "embed", "mlp")),
    (r"\.moe_mlp\.w2$", ("expert", "mlp", "embed")),
    (r"\.moe_mlp\.b1$", ("expert", "mlp")),
    (r"\.moe_mlp\.b2$", ("expert", "embed")),
)

# Leaves replicated over tp that a routed MLP uses inside its tp region
# (``models.moe.MoeMlp``): the router, whose logits feed a combine over the
# rank's slice of the experts' hidden units, and ``b2``, added on tp member
# 0 alone (once, as a row-parallel bias). Their gradient on a tp rank is a
# partial sum over tp (``parallel.fsdp.reduce_grads``).
TP_PARTIAL = (r"\.moe_mlp\.router\.kernel$", r"\.moe_mlp\.b2$")

# Logical axis -> mesh axis (None: replicated). ``seq`` is the activations'
# sequence dimension: ``parallel.tp.tp_rules(sequence_parallel=True)`` maps
# it onto tp between the blocks (Megatron sequence parallelism). JAX's
# ``batch`` -> (dp, fsdp) is the data path's (``data.sharded_batches``).
DEFAULT_LOGICAL_RULES: dict[str, str | None] = {
    "seq": None,
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "pos": None,
    "norm": None,
    "expert": "ep",
}

# Logical axes whose size the mesh axis must divide (no padded heads or
# hidden units); the others are padded up to a multiple.
_EXACT = ("heads", "mlp", "expert")
# The mesh axes a leaf is cut over, in the order a save gathers them.
SHARD_AXES = ("fsdp", "tp", "ep")


def make_rules(**overrides) -> dict:
    """:data:`DEFAULT_LOGICAL_RULES` with per-logical-axis overrides."""
    return {**DEFAULT_LOGICAL_RULES, **overrides}


def logical_axes(name: str) -> tuple[str, ...]:
    """The logical axes of leaf ``name``; a leaf no entry names is
    refused (a tp/fsdp/ep model's every leaf must be placed)."""
    for pattern, axes in LOGICAL_AXES:
        if re.search(pattern, name):
            return axes
    raise ValueError(f"leaf {name!r} has no logical axes in "
                     "sharding.LOGICAL_AXES: it cannot be placed over tp, "
                     "fsdp or ep")


def tp_partial(name: str) -> bool:
    """Leaf ``name`` is replicated over tp but used inside a routed MLP's
    tp region (:data:`TP_PARTIAL`)."""
    return any(re.search(p, name) for p in TP_PARTIAL)


def validate_logical_spec(name: str, mesh_axes: tuple) -> None:
    """Refuse two dimensions of one leaf on one mesh axis (the JAX
    package's ``validate_logical_spec``)."""
    live = [a for a in mesh_axes if a is not None]
    if len(live) != len(set(live)):
        raise ValueError(f"leaf {name!r}: two dimensions on one mesh axis "
                         f"{mesh_axes}")


def mesh_axes(name: str, shape, mesh_shape: dict,
              rules: dict | None = None) -> tuple:
    """Leaf ``name``'s mesh axis per dimension (None: replicated), the
    axes of size 1 dropped (a placement no-op)."""
    rules = DEFAULT_LOGICAL_RULES if rules is None else rules
    axes = logical_axes(name)
    if len(axes) != len(shape):
        raise ValueError(f"leaf {name!r} of shape {tuple(shape)} has "
                         f"logical axes {axes}")
    out = tuple(rules.get(a) if mesh_shape.get(rules.get(a), 1) > 1 else None
                for a in axes)
    validate_logical_spec(name, out)
    return out


class ShardLayout:
    """The placement of a model's leaves over the ``tp``, ``fsdp`` and
    ``ep`` axes of ``mesh``.

    - ``whole``: name -> the leaf's whole shape (the one-rank model's);
    - ``dims``: name -> {mesh axis: the dimension it cuts};
    - ``local``: name -> this rank's block shape.

    :meth:`take` cuts whole trees to this rank's blocks (a restore, JAX's
    weights in the tests), :meth:`gather` puts every rank's blocks back
    together on rank 0 (a save)."""

    def __init__(self, whole: dict, mesh, rules: dict | None = None):
        self.mesh = mesh
        self.rules = DEFAULT_LOGICAL_RULES if rules is None else rules
        self.whole = {k: tuple(s) for k, s in whole.items()}
        self.dims, self.local = {}, {}
        for k, shape in self.whole.items():
            spec = mesh_axes(k, shape, mesh.shape, self.rules)
            self.dims[k] = {a: d for d, a in enumerate(spec)
                            if a is not None}
            local = list(shape)
            for a, d in self.dims[k].items():
                n = mesh.shape[a]
                if logical_axes(k)[d] in _EXACT and shape[d] % n:
                    raise ValueError(
                        f"leaf {k!r}: {logical_axes(k)[d]} dimension "
                        f"{shape[d]} is not divisible by {a}={n}")
                local[d] = -(-shape[d] // n)
            self.local[k] = tuple(local)

    @property
    def sequence_parallel(self) -> bool:
        """Activations' ``seq`` over tp between the blocks."""
        return self.rules.get("seq") == "tp" and self.mesh.shape["tp"] > 1

    def axes_of(self, name: str) -> tuple:
        """The live mesh axes leaf ``name`` is sharded over."""
        return tuple(self.dims.get(name, {}))

    def block(self, name: str, axis: str) -> tuple[int, int]:
        """(start, valid length) of this rank's block of leaf ``name`` on
        the dimension ``axis`` cuts: the rows past the whole dimension are
        padding."""
        d = self.dims[name][axis]
        size = self.local[name][d]
        lo = self.mesh.coords[axis] * size
        return lo, max(0, min(size, self.whole[name][d] - lo))

    def take_leaf(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf (zero padded)."""
        if name not in self.dims or not self.dims[name]:
            return full
        out = full
        for a, d in self.dims[name].items():
            lo, n = self.block(name, a)
            part = out.narrow(d, lo, n)
            pad = self.local[name][d] - n
            if pad:
                shape = list(part.shape)
                shape[d] = pad
                part = torch.cat([part, part.new_zeros(shape)], dim=d)
            out = part
        return out.contiguous()

    def take(self, tree: dict) -> dict:
        """This rank's blocks of each leaf of a whole tree; other entries
        as they are."""
        return {k: self.take_leaf(k, v) if k in self.dims else v
                for k, v in tree.items()}

    def whole_shape(self, name: str, shape=None) -> tuple:
        if name not in self.whole:
            return tuple(shape)
        return self.whole[name]

    def whole_numel(self, tree: dict) -> int:
        """The whole model's element count from a rank's ``tree``."""
        return sum(math.prod(self.whole_shape(k, v.shape))
                   for k, v in tree.items())

    def gather(self, tree: dict) -> dict | None:
        """The whole tree of every rank's blocks on rank 0, None on every
        other rank. A collective of the ranks whose coordinates off tp, fsdp
        and ep are 0 (the others hold copies and return at once): over fsdp
        first, then over tp among the fsdp members 0, then over ep among
        the members 0 of both. Moved in fp32, as the other checkpoint
        gathers (gloo has no bf16 gather)."""
        if any(c for a, c in self.mesh.coords.items() if a not in SHARD_AXES):
            return None
        for i, axis in enumerate(SHARD_AXES):
            if self.mesh.shape[axis] == 1:
                continue
            if any(self.mesh.coords[a] for a in SHARD_AXES[:i]):
                return None
            names = [k for k in tree if axis in self.dims.get(k, {})]
            if not names:
                continue
            flat = torch.cat([tree[k].detach().reshape(-1).float()
                              for k in names])
            full = comms.gather(flat, self.mesh, axis)
            if full is None:
                return None
            chunks = full.chunk(self.mesh.shape[axis])
            out, o = dict(tree), 0
            for k in names:
                n, shape = tree[k].numel(), tree[k].shape
                d = self.dims[k][axis]
                whole = torch.cat([c[o:o + n].view(shape) for c in chunks],
                                  dim=d)
                out[k] = whole.narrow(d, 0, self.whole[k][d]).to(
                    tree[k].dtype)
                o += n
            tree = out
        return tree


def shard_model(model, mesh, rules: dict | None = None,
                vocab_size: int | None = None) -> ShardLayout | None:
    """Place a model built with its local sizes (heads, mlp and vocab cut
    over tp, experts over ep) on ``mesh``: the layout of its leaves, each
    fsdp-cut leaf replaced by an empty parameter of this rank's block
    (``init_weights`` or a restore fills it), and each owning module told
    which dimension of which leaf to gather over fsdp before use
    (``parallel.fsdp.full_param``). None when tp, fsdp and ep are all 1."""
    if mesh is None or all(mesh.shape[a] == 1 for a in SHARD_AXES):
        return None
    rules = DEFAULT_LOGICAL_RULES if rules is None else rules
    whole = {}
    for k, p in model.named_parameters():
        shape = list(p.shape)
        for d, ax in enumerate(logical_axes(k)):
            axis = rules.get(ax)
            if axis in ("tp", "ep") and mesh.shape[axis] > 1:
                shape[d] = (vocab_size if ax == "vocab"
                            else shape[d] * mesh.shape[axis])
        whole[k] = tuple(shape)
    layout = ShardLayout(whole, mesh, rules)
    for k, p in list(model.named_parameters()):
        for a, d in layout.dims[k].items():
            if a in ("tp", "ep") and p.shape[d] != layout.local[k][d]:
                raise ValueError(f"leaf {k!r}: built with {p.shape[d]} "
                                 f"rows on {a}, the layout holds "
                                 f"{layout.local[k][d]}")
        if "fsdp" not in layout.dims[k]:
            continue
        owner_name, _, leaf = k.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = torch.nn.Parameter(torch.empty(
            layout.local[k], dtype=p.dtype, device=p.device))
        d = layout.dims[k]["fsdp"]
        if "fsdp_dims" not in owner.__dict__:
            owner.fsdp_dims = {}
        owner.fsdp_dims[leaf] = (d, layout.whole[k][d])
        owner.fsdp_mesh = mesh
    return layout
