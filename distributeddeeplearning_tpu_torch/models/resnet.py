"""ResNet-18/50: the JAX package's ``models/resnet.py`` in torch.

- Inputs arrive NHWC, as the JAX batches do; ``permute(0, 3, 1, 2)`` of a
  contiguous NHWC tensor is a channels-last NCHW view (no copy), and the
  conv weights are kept channels-last too, so cuDNN runs its NHWC kernels.
- Parameters stay fp32; convs and the Dense head compute in the model's
  ``dtype``, cast at use (flax's ``dtype=bfloat16``). BatchNorm takes its
  statistics and normalises in fp32 and returns ``dtype``; the logits are
  fp32.
- Padding is flax's ``"SAME"``: ``total = max((ceil(n/s)-1)*s + k - n, 0)``
  split ``low = total // 2``, ``high = total - low``, which is asymmetric
  at stride 2 (a 7x7/2 stem at 224 pads (2, 3)); the max pool pads with
  -inf.
- BatchNorm statistics are taken over the global batch, as JAX's are under
  a batch sharded over dp: each rank's fp32 ``[sum x, sum x², count]`` is
  all-reduced over dp (``comms.psum_differentiable``, whose backward
  all-reduces the gradient), then ``mean = S/N``, ``var = max(E[x²] -
  mean², 0)`` (flax's biased ``use_fast_variance``), eps 1e-5. The running
  statistics move as ``ra = 0.9 ra + 0.1 batch`` in the training forward,
  in place on the module's fp32 buffers, and not in a remat recompute.
- ``remat`` ('none' | 'full' | 'dots') checkpoints each residual block
  (``models/remat.py``); 'dots' saves no conv (a conv is no dot, as in
  JAX), so it recomputes what 'full' does.
- On a ``mesh`` with tp or fsdp above 1 the model holds this rank's blocks
  (``sharding.shard_model``, JAX's ``models/resnet.py`` axes): each conv
  weight's output channels over fsdp, gathered whole in the compute dtype
  just before its conv (``parallel.fsdp.full_param``; under remat 'none' a
  residual block's gathered weights are freed at the end of its forward
  and gathered again in its backward), the head's ``[features]`` over fsdp
  and its classes over tp (the logits gathered over tp before the loss).
  The batch is split over dp x fsdp, so BatchNorm's sums run over both.
- Names follow the flax tree (``ConvBN_0.Conv_0``, ``BottleneckBlock_3``,
  ``Dense_0``); a parameter in torch's layout is named ``weight`` where
  flax's is ``kernel`` (OIHW against HWIO, [out, in] against [in, out]),
  which ``weights.py`` transposes.
"""

from __future__ import annotations

import contextlib

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.fsdp import full_param
from ..parallel.tp import check_tp_fsdp, class_parallel_logits
from ..sharding import make_rules, shard_model
from . import register
from .gpt2 import as_torch_dtype
from .remat import check_remat, checkpoint_block, recomputing
from .transformer import block_scope

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of flax's ``"SAME"`` along one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """``x`` (NCHW) padded as ``"SAME"`` for a k x k window of stride s, and
    the symmetric padding left for the op itself: a symmetric pad goes to
    the conv (no copy), an asymmetric one is done here."""
    ph, pw = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _f32(t):
    """``t`` promoted to at least fp32 (flax's statistics dtype)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class _BatchStats(torch.autograd.Function):
    """Per-channel fp32 ``[sum x, sum x²]`` of an NCHW ``x`` over N, H, W.
    Saves ``x`` as it is (no fp32 copy)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = _f32(x)
        return torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g1, g2 = (t.view(1, -1, 1, 1) for t in g)
        return (g1 + 2.0 * _f32(x) * g2).to(x.dtype)


class _Normalize(torch.autograd.Function):
    """``y = (x - mean) * (inv * scale) + bias`` in fp32 (flax's
    ``_normalize``), returned in ``out_dtype``. Saves ``x`` as it is and the
    per-channel vectors; the fp32 intermediates live only inside each
    call."""

    @staticmethod
    def forward(ctx, x, mean, inv, scale, bias, out_dtype):
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.dtypes = (mean.dtype, inv.dtype, scale.dtype, bias.dtype)
        c = (1, -1, 1, 1)
        mul = _f32(inv) * _f32(scale)
        y = (_f32(x) - _f32(mean).view(c)) * mul.view(c)
        return (y + _f32(bias).view(c)).to(out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, mean, inv, scale = ctx.saved_tensors
        c = (1, -1, 1, 1)
        gyf = _f32(gy)
        inv, scale = _f32(inv), _f32(scale)
        mul = inv * scale
        gbias = gyf.sum((0, 2, 3))
        gdm = (gyf * (_f32(x) - _f32(mean).view(c))).sum((0, 2, 3))
        gx = (gyf * mul.view(c)).to(x.dtype)
        dm, di, ds, db = ctx.dtypes
        return (gx, (-mul * gbias).to(dm), (gdm * scale).to(di),
                (gdm * inv).to(ds), gbias.to(db), None)


_LOCAL_STATISTICS = [False]


@contextlib.contextmanager
def local_batch_statistics():
    """Within it, a training forward's BatchNorm takes the statistics of
    this rank's rows alone (no sync over dp): the explicit data-parallel
    sync's steps, whose reference runs each member's forward under
    ``shard_map`` and averages the running statistics after the step."""
    _LOCAL_STATISTICS[0] = True
    try:
        yield
    finally:
        _LOCAL_STATISTICS[0] = False


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    dim of NCHW input, its statistics synced over the mesh's batch ranks
    (dp and fsdp)."""

    def __init__(self, features: int, dtype, mesh=None, device=None):
        super().__init__()
        self.dtype, self.mesh = dtype, mesh
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, train: bool):
        if not train:
            inv = torch.rsqrt(self.var + BN_EPS)
            return _Normalize.apply(x, self.mean, inv, self.scale, self.bias,
                                    self.dtype)
        from ..comms import psum_differentiable

        sums = _BatchStats.apply(x)
        count = float(x.shape[0] * x.shape[2] * x.shape[3])
        stats = torch.cat([sums.reshape(-1),
                           sums.new_full((1,), count)])
        for axis in ("dp", "fsdp"):
            if (self.mesh is not None and self.mesh.shape[axis] > 1
                    and not _LOCAL_STATISTICS[0]):
                stats = psum_differentiable(stats, self.mesh, axis)
        c = x.shape[1]
        n = stats[2 * c]
        mean, mean2 = stats[:c] / n, stats[c:2 * c] / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if not recomputing():  # the forward moved them already
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * var)
        return _Normalize.apply(x, mean, torch.rsqrt(var + BN_EPS),
                                self.scale, self.bias, self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False)``: an OIHW weight kept channels-last, cast to ``dtype``
    at use."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 strides: int, dtype, device=None):
        super().__init__()
        self.kernel, self.strides, self.dtype = kernel, strides, dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel, kernel, device=device
        ).contiguous(memory_format=torch.channels_last))

    def forward(self, x):
        w = full_param(self, "weight", self.dtype).to(self.dtype)
        if self.kernel == 1:
            # A 1x1 window of stride s reads every s-th pixel ("SAME" pads
            # nothing), so it is a 1x1 conv of the strided view; torch's
            # CPU backward of a strided 1x1 conv over channels-last input
            # crashes.
            s = self.strides
            return F.conv2d(x[:, :, ::s, ::s].to(self.dtype), w)
        x, pad = _pad_same(x, self.kernel, self.strides)
        return F.conv2d(x.to(self.dtype), w, stride=self.strides,
                        padding=pad)


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, use_relu: bool = True, *, dtype, mesh=None,
                 device=None):
        super().__init__()
        self.use_relu = use_relu
        self.Conv_0 = Conv(in_features, features, kernel, strides, dtype,
                           device)
        self.BatchNorm_0 = BatchNorm(features, dtype, mesh, device)

    def forward(self, x, train: bool):
        x = self.BatchNorm_0(self.Conv_0(x), train)
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    """2x 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 **kw):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 3, strides, **kw)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, use_relu=False, **kw)
        if strides != 1 or in_features != features:
            self.ConvBN_2 = ConvBN(in_features, features, 1, strides,
                                   use_relu=False, **kw)

    def forward(self, x, train: bool):
        y = self.ConvBN_1(self.ConvBN_0(x, train), train)
        residual = self.ConvBN_2(x, train) if hasattr(self, "ConvBN_2") else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1(x4) bottleneck (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 **kw):
        super().__init__()
        out = features * 4
        self.ConvBN_0 = ConvBN(in_features, features, 1, 1, **kw)
        self.ConvBN_1 = ConvBN(features, features, 3, strides, **kw)
        self.ConvBN_2 = ConvBN(features, out, 1, 1, use_relu=False, **kw)
        if strides != 1 or in_features != out:
            self.ConvBN_3 = ConvBN(in_features, out, 1, strides,
                                   use_relu=False, **kw)

    def forward(self, x, train: bool):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x, train), train),
                          train)
        residual = self.ConvBN_3(x, train) if hasattr(self, "ConvBN_3") else x
        return F.relu(y + residual)


class Dense(nn.Module):
    """flax ``nn.Dense``: a [out, in] weight and a bias, cast to ``dtype``
    at use."""

    def __init__(self, in_features: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        w = full_param(self, "weight", self.dtype).to(self.dtype)
        return F.linear(x.to(self.dtype), w, self.bias.to(self.dtype))


class ResNet(nn.Module):
    """ResNet over NHWC RGB inputs. ``small_stem=True`` is the CIFAR stem
    (3x3/1, no max pool); otherwise the ImageNet stem (7x7/2 + 3x3/2 max
    pool).
    ``mesh``: the ranks whose BatchNorm statistics are synced (over dp
    and fsdp), and over which the leaves are cut (fsdp and tp)."""

    def __init__(self, block, stage_sizes, num_classes: int, width: int = 64,
                 small_stem: bool = False, remat: str = "none",
                 dtype="float32", mesh=None, device=None):
        super().__init__()
        self.remat = check_remat(remat)
        tp = check_tp_fsdp("resnet", mesh)
        self.dtype, self.mesh = as_torch_dtype(dtype), mesh
        self.small_stem, self.num_classes = small_stem, num_classes
        kw = dict(dtype=self.dtype, mesh=mesh, device=device)
        if small_stem:
            self.ConvBN_0 = ConvBN(3, width, 3, 1, **kw)
        else:
            self.ConvBN_0 = ConvBN(3, width, 7, 2, **kw)
        features, k = width, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                setattr(self, f"{block.__name__}_{k}",
                        block(features, width * 2**i, strides, **kw))
                features = width * 2**i * block.expansion
                k += 1
        self.num_blocks = k
        self.block_name = block.__name__
        # Every tp rank runs the convolutions whole, the head on its
        # classes (``benchmark.model_share``).
        self.tp_repeated = tuple(n for n, _ in self.named_children())
        self.Dense_0 = Dense(features, -(-num_classes // tp), self.dtype,
                             device)
        # This rank's blocks of the leaves over tp and fsdp (None: whole).
        self.shards = shard_model(self, mesh, make_rules(), num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init in distribution, drawn on the CPU from ``generator``
        (so a seed gives the same weights on every device): conv kernels
        ``kaiming_normal`` (a normal truncated at 2 sigma, fan-in scale
        2.0), the Dense kernel and bias zero, BatchNorm scale 1, bias 0,
        running mean 0 and variance 1."""
        for name, p in self.named_parameters():
            if name.endswith("Conv_0.weight"):
                shape = (p.shape if self.shards is None
                         else self.shards.whole_shape(name, p.shape))
                fan_in = shape[1] * shape[2] * shape[3]
                # flax's truncated normal rescales by the stddev of a unit
                # normal truncated to [-2, 2].
                std = math.sqrt(2.0 / fan_in) / .87962566103423978
                w = torch.empty(shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                p.copy_(w if self.shards is None
                        else self.shards.take_leaf(name, w))
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("var") else 0.0)

    def forward(self, x: torch.Tensor, *, train: bool = True,
                generator=None) -> torch.Tensor:
        """``x`` [N, H, W, C] -> fp32 logits [N, num_classes]. ``train``:
        batch statistics (synced over dp) and a running-statistics update;
        else the running statistics. ``generator`` is unused (no
        dropout)."""
        del generator
        x = x.permute(0, 3, 1, 2)  # NHWC -> a channels-last NCHW view
        x = self.ConvBN_0(x, train)
        if not self.small_stem:
            x, _ = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2)
        for k in range(self.num_blocks):
            block = getattr(self, f"{self.block_name}_{k}")
            with block_scope(self.mesh, self.remat):
                x = checkpoint_block(lambda y, b=block: b(y, train), x,
                                     remat=self.remat, module=block)
        x = _f32(x).mean((2, 3)).to(self.dtype)
        return class_parallel_logits(x, self.Dense_0, self.mesh,
                                     self.num_classes).float()


@register("resnet18")
def resnet18(num_classes: int = 10, width: int = 64, small_stem: bool = True,
             remat: str = "none", dtype="float32", **kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, width, small_stem,
                  remat, dtype, **_known(kw))


@register("resnet50")
def resnet50(num_classes: int = 1000, width: int = 64,
             small_stem: bool = False, remat: str = "none", dtype="float32",
             **kw) -> ResNet:
    return ResNet(BottleneckBlock, (3, 4, 6, 3), num_classes, width,
                  small_stem, remat, dtype, **_known(kw))


def _known(kw: dict) -> dict:
    """The torch-side keywords; the rest are dropped, as the JAX
    factories' ``**_`` drops them."""
    return {k: v for k, v in kw.items()
            if k in ("mesh", "device")}
