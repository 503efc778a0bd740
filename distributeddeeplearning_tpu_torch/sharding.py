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
  their biases); ViT's, BERT's and ResNet's (``models/vit.py``: the patch
  kernel ``("conv_h", "conv_w", "conv_in", "embed")``, ``cls_token`` and
  ``pos_embed`` ``("pos", "embed")``, the head ``("embed", "vocab")``;
  ``models/bert.py``: ``("pos", "embed")`` for the position and token-type
  tables, ``("embed", "mlp")`` for ``mlm_transform``, ``("vocab",)`` for
  ``mlm_bias``; ``models/resnet.py``: each conv's output channel
  ``embed``, the head's classes ``vocab``); a pipelined model's stage
  leaves carry ``stage`` before their block's axes, and its embedding
  tables (and Llama's untied head) ``vocab_pp`` for ``vocab``
  (``models/pipeline.py``'s ``("vocab_pp", "embed")``);
- :data:`DEFAULT_LOGICAL_RULES`: logical axis -> mesh axis or axes
  (``embed`` over ``fsdp``; ``heads``, ``mlp`` and ``vocab`` over ``tp``;
  ``vocab_pp`` over ``tp`` then ``pp``; ``expert`` over ``ep``; the rest
  replicated), with :func:`validate_logical_spec`'s refusal of two
  dimensions of one leaf on one mesh axis.

:class:`ShardLayout` applies them to one model on one mesh: each leaf's
whole shape, the dimension each live axis (size > 1) cuts, and this rank's
block of it. A dimension of ``n`` over ``k`` ranks is cut into blocks of
``ceil(n / k)``; the last rank's block is padded with zeros where ``k``
does not divide ``n`` (GPT-2's vocabulary of 50257 over tp, as XLA pads
it). A dimension over two axes (``vocab_pp``) is cut over the first, and
the rank's block of it over the second. ``heads``, ``mlp`` and ``expert``
must divide: a padded head would be a head (JAX's ``check_moe_shapes``
refuses experts that ``ep`` does not divide).
"""

from __future__ import annotations

import math
import re

import torch

from . import comms

# Leaf name (a regular expression over the flattened parameter path) ->
# logical axes, first match wins.
LOGICAL_AXES: tuple[tuple[str, tuple[str, ...]], ...] = (
    (r"(^|\.)(wte|embed|word_embeddings)\.embedding$", ("vocab", "embed")),
    (r"(^|\.)(wpe|position_embeddings|token_type_embeddings)\.embedding$",
     ("pos", "embed")),
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
    # ViT (the patch kernel in its HWIO layout) and BERT.
    (r"^patch_embed\.kernel$", ("conv_h", "conv_w", "conv_in", "embed")),
    (r"^patch_embed\.bias$", ("embed",)),
    (r"^(cls_token|pos_embed)$", ("pos", "embed")),
    (r"^head\.kernel$", ("embed", "vocab")),
    (r"^head\.bias$", ("vocab",)),
    (r"(^|\.)(embeddings_ln|mlm_ln)\.(scale|bias)$", ("norm",)),
    (r"(^|\.)mlm_transform\.kernel$", ("embed", "mlp")),
    (r"(^|\.)mlm_transform\.bias$", ("mlp",)),
    (r"(^|\.)mlm_bias$", ("vocab",)),
    # ResNet, whose leaves keep torch's layouts: a conv weight [out, in,
    # kh, kw] (JAX's HWIO kernel's ``embed`` is the output channel), the
    # head [classes, features].
    (r"\.Conv_0\.weight$", ("embed", "conv_in", "conv_h", "conv_w")),
    (r"\.BatchNorm_0\.(scale|bias)$", ("norm",)),
    (r"^Dense_0\.weight$", ("vocab", "embed")),
    (r"^Dense_0\.bias$", ("vocab",)),
)

# A pipelined model's stage-stacked leaves (``<stack>.stages.block_j...``):
# the ``stage`` axis before their block's axes. The rows over pp are
# ``parallel.pp.StageRows``' to cut, so ``stage`` maps to no mesh axis
# here.
STAGE_LEAF = r"(^|\.)stages\."

# Leaves replicated over tp that a routed MLP uses inside its tp region
# (``models.moe.MoeMlp``): the router, whose logits feed a combine over the
# rank's slice of the experts' hidden units, and ``b2``, added on tp member
# 0 alone (once, as a row-parallel bias). Their gradient on a tp rank is a
# partial sum over tp (``parallel.fsdp.reduce_grads``).
TP_PARTIAL = (r"\.moe_mlp\.router\.kernel$", r"\.moe_mlp\.b2$")

# Logical axis -> mesh axis (None: replicated). ``seq`` is the activations'
# sequence dimension: ``parallel.tp.tp_rules(sequence_parallel=True)`` maps
# it onto (cp, tp) between the blocks (Megatron sequence parallelism within
# a rank's cp block; the cp cut is the task's, ``train.seq_block``). JAX's
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
    "stage": None,
    # A pipelined model's tables: not replicated on every stage, each pp
    # rank stores its block of its tp slice (JAX's rule).
    "vocab_pp": ("tp", "pp"),
    "conv_h": None,
    "conv_w": None,
    "conv_in": None,
}

# Logical axes whose size the mesh axis must divide (no padded heads or
# hidden units); the others are padded up to a multiple.
_EXACT = ("heads", "mlp", "expert")
# The mesh axes a leaf is cut over, in the order a save gathers them.
SHARD_AXES = ("fsdp", "tp", "ep")


def make_rules(**overrides) -> dict:
    """:data:`DEFAULT_LOGICAL_RULES` with per-logical-axis overrides."""
    return {**DEFAULT_LOGICAL_RULES, **overrides}


def logical_axes(name: str, vocab_pp=()) -> tuple[str, ...]:
    """The logical axes of leaf ``name`` (``vocab_pp`` for ``vocab`` where
    ``vocab_pp`` names it); a leaf no entry names is refused (a
    tp/fsdp/ep model's every leaf must be placed)."""
    stage = ("stage",) if re.search(STAGE_LEAF, name) else ()
    for pattern, axes in LOGICAL_AXES:
        if re.search(pattern, name):
            if name in vocab_pp:
                axes = tuple("vocab_pp" if a == "vocab" else a for a in axes)
            return stage + axes
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
    live = [a for axes in mesh_axes if axes is not None
            for a in (axes if isinstance(axes, tuple) else (axes,))]
    if len(live) != len(set(live)):
        raise ValueError(f"leaf {name!r}: two dimensions on one mesh axis "
                         f"{mesh_axes}")


def mesh_axes(name: str, shape, mesh_shape: dict,
              rules: dict | None = None, vocab_pp=()) -> tuple:
    """Leaf ``name``'s mesh axes per dimension, in the order they cut it
    (a tuple; empty: replicated), the axes of size 1 dropped (a placement
    no-op)."""
    rules = DEFAULT_LOGICAL_RULES if rules is None else rules
    axes = logical_axes(name, vocab_pp)
    if len(axes) != len(shape):
        raise ValueError(f"leaf {name!r} of shape {tuple(shape)} has "
                         f"logical axes {axes}")
    out = []
    for a in axes:
        rule = rules.get(a)
        rule = rule if isinstance(rule, tuple) else (rule,)
        out.append(tuple(m for m in rule if mesh_shape.get(m, 1) > 1))
    out = tuple(out)
    validate_logical_spec(name, out)
    return out


class ShardLayout:
    """The placement of a model's leaves over the ``tp``, ``fsdp`` and
    ``ep`` axes of ``mesh``.

    - ``whole``: name -> the leaf's whole shape (the one-rank model's);
    - ``dims``: name -> {mesh axis: the dimension it cuts}, in the order
      the axes cut;
    - ``outer``: name -> {mesh axis: its dimension's length before that
      axis cuts it} (the whole, or the first axis's block under
      ``vocab_pp``);
    - ``local``: name -> this rank's block shape.

    :meth:`take` cuts whole trees to this rank's blocks (a restore, JAX's
    weights in the tests), :meth:`gather` puts every rank's blocks back
    together on rank 0 (a save)."""

    def __init__(self, whole: dict, mesh, rules: dict | None = None,
                 vocab_pp=()):
        self.mesh = mesh
        self.rules = DEFAULT_LOGICAL_RULES if rules is None else rules
        self.whole = {k: tuple(s) for k, s in whole.items()}
        # The stage leaves of a model pipelined over pp > 1: each rank holds
        # its rows (``whole`` says the rows it holds), so a norm sums their
        # squares over pp too (``parallel.fsdp.leaf_class``).
        self.pp_names: set = set()
        self.dims, self.outer, self.local = {}, {}, {}
        for k, shape in self.whole.items():
            spec = mesh_axes(k, shape, mesh.shape, self.rules, vocab_pp)
            self.dims[k] = {a: d for d, axes in enumerate(spec)
                            for a in axes}
            self.outer[k] = {}
            local = list(shape)
            for a, d in self.dims[k].items():
                n, axis = mesh.shape[a], logical_axes(k)[d]
                if axis in _EXACT and local[d] % n:
                    raise ValueError(
                        f"leaf {k!r}: {axis} dimension {local[d]} is not "
                        f"divisible by {a}={n}")
                self.outer[k][a] = local[d]
                local[d] = -(-local[d] // n)
            self.local[k] = tuple(local)

    @property
    def sequence_parallel(self) -> bool:
        """Activations' ``seq`` over tp between the blocks."""
        return ("tp" in (self.rules.get("seq") or ())
                and self.mesh.shape["tp"] > 1)

    def axes_of(self, name: str) -> tuple:
        """The live mesh axes leaf ``name`` is sharded over."""
        return tuple(self.dims.get(name, {}))

    def norm_axes(self, name: str) -> tuple:
        """:meth:`axes_of`, and pp for a pipeline stage's rows."""
        return self.axes_of(name) + (("pp",) if name in self.pp_names
                                     else ())

    def take_axis(self, name: str, t: torch.Tensor, axis: str
                  ) -> torch.Tensor:
        """This rank's block over ``axis`` of ``t``, leaf ``name`` as it is
        before ``axis`` cuts it: ``ceil(n / k)`` rows of its dimension, the
        rows past its end zeros."""
        d, n = self.dims[name][axis], self.mesh.shape[axis]
        size = -(-self.outer[name][axis] // n)
        lo = self.mesh.coords[axis] * size
        part = t.narrow(d, lo, max(0, min(size, t.shape[d] - lo)))
        pad = size - part.shape[d]
        if pad:
            shape = list(part.shape)
            shape[d] = pad
            part = torch.cat([part, part.new_zeros(shape)], dim=d)
        return part

    def take_leaf(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf (zero padded)."""
        out = full
        for a in self.dims.get(name, {}):
            out = self.take_axis(name, out, a)
        return out.contiguous()

    def gather_axis(self, name: str, block: torch.Tensor, axis: str
                    ) -> torch.Tensor:
        """Leaf ``name`` as it is before ``axis`` cuts it, from every
        member's ``block`` over ``axis`` (an all-gather, not differentiated
        through; the inverse of :meth:`take_axis`)."""
        return comms.all_gather_dim(block, self.mesh, axis,
                                    self.dims[name][axis],
                                    self.outer[name][axis])

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
        """The whole model's element count from a rank's ``tree`` (every
        pp rank's stage rows counted)."""
        pp = self.mesh.shape["pp"]
        return sum(math.prod(self.whole_shape(k, v.shape))
                   * (pp if k in self.pp_names else 1)
                   for k, v in tree.items())

    def gather(self, tree: dict) -> dict | None:
        """The whole tree of every rank's blocks on rank 0, None on every
        other rank. A collective of the ranks whose coordinates off tp, fsdp,
        ep and pp are 0 (the others hold copies and return at once): the
        tables cut over pp (``vocab_pp``) over pp first, every stage's ranks
        taking part (the pp members off 0 then leave them to member 0);
        then over fsdp, then over tp among the fsdp members 0, then over ep
        among the members 0 of both. Under pp each stage's ranks put their
        own rows together (on their fsdp, tp and ep member 0s), which
        ``parallel.pp.StageRows.gather`` then puts together over pp. Moved
        in fp32, as the other checkpoint gathers (gloo has no bf16
        gather)."""
        if any(c for a, c in self.mesh.coords.items()
               if a not in SHARD_AXES + ("pp",)):
            return None
        names = [k for k in tree if "pp" in self.dims.get(k, {})]
        if names:
            whole = self._gather_names(tree, names, "pp")
            tree = ({k: v for k, v in tree.items() if k not in names}
                    if whole is None else whole)
        for i, axis in enumerate(SHARD_AXES):
            if self.mesh.shape[axis] == 1:
                continue
            if any(self.mesh.coords[a] for a in SHARD_AXES[:i]):
                return None
            names = [k for k in tree if axis in self.dims.get(k, {})]
            if names:
                tree = self._gather_names(tree, names, axis)
                if tree is None:
                    return None
        return tree

    def _gather_names(self, tree: dict, names: list, axis: str
                      ) -> dict | None:
        """``tree`` with leaves ``names`` put back together over ``axis``
        on its member 0 (as they are before ``axis`` cuts them), None on
        the others."""
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
            whole = torch.cat([c[o:o + n].view(shape) for c in chunks], dim=d)
            out[k] = whole.narrow(d, 0, self.outer[k][axis]).to(tree[k].dtype)
            o += n
        return out


def shard_model(model, mesh, rules: dict | None = None,
                vocab_size: int | None = None,
                vocab_pp=()) -> ShardLayout | None:
    """Place a model built with its local sizes (heads, mlp and vocab cut
    over tp, experts over ep) on ``mesh``: the layout of its leaves, each
    leaf cut over fsdp or pp replaced by an empty parameter of this rank's
    block (``init_weights`` or a restore fills it), and each owning module
    told which dimension of which leaf to gather over fsdp before use
    (``parallel.fsdp.full_param``). None when tp, fsdp and ep are all 1,
    unless ``vocab_pp`` names tables to cut over pp > 1 (a model pipelined
    over pp alone: the layout cuts those tables only). ``vocab_size``: the
    whole size of every ``vocab`` dimension (the vocabulary, or an image
    head's classes); ``vocab_pp``: the leaves whose ``vocab`` is
    ``vocab_pp`` (a pipelined model's tables)."""
    if mesh is None or (all(mesh.shape[a] == 1 for a in SHARD_AXES)
                        and not (vocab_pp and mesh.shape["pp"] > 1)):
        return None
    rules = DEFAULT_LOGICAL_RULES if rules is None else rules
    whole = {}
    for k, p in model.named_parameters():
        shape = list(p.shape)
        for d, ax in enumerate(logical_axes(k, vocab_pp)):
            rule = rules.get(ax)
            for axis in rule if isinstance(rule, tuple) else (rule,):
                if axis in ("tp", "ep") and mesh.shape[axis] > 1:
                    shape[d] = (vocab_size if ax in ("vocab", "vocab_pp")
                                else shape[d] * mesh.shape[axis])
        whole[k] = tuple(shape)
    layout = ShardLayout(whole, mesh, rules, vocab_pp)
    for k, p in list(model.named_parameters()):
        for a, d in layout.dims[k].items():
            built = -(-layout.outer[k][a] // mesh.shape[a])
            if a in ("tp", "ep") and p.shape[d] != built:
                raise ValueError(f"leaf {k!r}: built with {p.shape[d]} "
                                 f"rows on {a}, the layout holds {built}")
        if not {"fsdp", "pp"} & set(layout.dims[k]):
            continue
        owner_name, _, leaf = k.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        owner._parameters[leaf] = torch.nn.Parameter(torch.empty(
            layout.local[k], dtype=p.dtype, device=p.device))
        if "fsdp" not in layout.dims[k]:
            continue
        d = layout.dims[k]["fsdp"]
        if "fsdp_dims" not in owner.__dict__:
            owner.fsdp_dims = {}
        # A stage leaf is used a row at a time (``parallel.pp``): its
        # dimension counts from the row's first.
        row = 1 if logical_axes(k)[0] == "stage" else 0
        owner.fsdp_dims[leaf] = (d - row, layout.whole[k][d])
        owner.fsdp_mesh = mesh
    return layout
