"""ResNet-18/50 of the port against the JAX package's ``models/resnet.py``,
and the classification task and SGD against the JAX trainer's.

- Model parity on the same weights (the JAX init's tree, every leaf
  redrawn from a seeded numpy generator so no logit is trivially zero,
  carried across by ``weights.to_torch_layout``): ``resnet18`` (CIFAR
  stem, width 8, 16²) and ``resnet50`` (ImageNet stem, width 4, 32² and
  33²). 32² pads every stride-2 window asymmetrically as flax's "SAME"
  does (the 7x7/2 stem (2, 3), the max pool and the 3x3/2 convs (0, 1)),
  33² symmetrically. In fp32, logits and the updated ``batch_stats``
  within 1e-5 relative (``train`` True and False), except ResNet-50's
  training forward: 53 BatchNorms over as few as 4 values a channel
  amplify fp32 rounding, so that JAX's own fp32 logits lie 3.7e-4 (of the
  largest logit) from a float64 evaluation of the same network, and the
  port's 1.8e-4. There the two are held at ``FP32_DEEP_TRAIN_TOL`` in
  fp32, and in float64 on both sides at 1e-9. In bf16 model dtype within
  ``BF16_TOL``: ResNet-18 training and evaluating, ResNet-50
  evaluating.
- The loss with label smoothing 0.1, its ``xent`` and ``accuracy``,
  against JAX's ``classification_task``.
- ``SGD`` against ``make_optimizer("sgd", ...)``'s optax chain for 10
  updates: the decay mask, the clip, the cosine warmup and the momentum.
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import models, train, weights
from distributeddeeplearning_tpu_torch.models.resnet import same_pads

jax_models = importlib.import_module("distributeddeeplearning_tpu.models")
jax_train = importlib.import_module("distributeddeeplearning_tpu.train")

torch.set_num_threads(4)

# bf16 model dtype: the convs round their inputs, weights and outputs to
# bf16 (8 mantissa bits) on both sides, in another order of summation.
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# ResNet-50's fp32 training forward, relative to the largest logit: about
# 5x JAX's own distance from float64 (see the module docstring).
FP32_DEEP_TRAIN_TOL = 2e-3

CASES = {
    "resnet18_16": ("resnet18", dict(num_classes=10, width=8), 16),
    "resnet50_32": ("resnet50", dict(num_classes=10, width=4), 32),
    "resnet50_33": ("resnet50", dict(num_classes=10, width=4), 33),
}


def _jax_variables(name, kw, size, dtype, seed=0):
    """The JAX model and its variables, every leaf redrawn from ``seed``
    (running variances positive)."""
    jmodel = jax_models.get_model(name, dtype=dtype, **kw)
    x = jnp.zeros((2, size, size, 3), jnp.float32)
    # Shapes only: every leaf is redrawn below.
    variables = nn.meta.unbox(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, train=False)))
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        noise = rng.standard_normal(shape)
        if name == "kernel":  # fan-in scaled
            return (noise * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(
                np.float32)
        return ((name == "scale") + 0.1 * noise).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(redraw, variables)
    return jmodel, variables


def _torch_model(name, kw, variables, dtype):
    model = models.get_model(name, dtype=dtype, **kw)
    sd = weights.to_torch_layout(
        weights.from_jax_params(variables["params"]),
        set(model.state_dict()))
    sd.update(weights.from_jax_params(variables["batch_stats"]))
    model.load_state_dict(sd, strict=True)
    return model


def _images(size, n=4, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _as_float64(model):
    """The port's model computing in float64 throughout."""
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def _run_both(case, dtype, train_mode):
    name, kw, size = CASES[case]
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float64": jnp.float64}[dtype]
    jmodel, variables = _jax_variables(name, kw, size, jdtype)
    model = _torch_model(name, kw, variables,
                         "float32" if dtype == "float64" else dtype)
    x = _images(size)
    if dtype == "float64":
        model = _as_float64(model)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 variables)
        x = x.astype(np.float64)
    if train_mode:
        jout, upd = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        jstats = weights.from_jax_params(upd["batch_stats"])
    else:
        jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, x)
        jstats = weights.from_jax_params(variables["batch_stats"])
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=train_mode)
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return np.asarray(jout), out.numpy(), jstats, stats


def _assert_match(case, dtype, train_mode, rtol, stats_rtol):
    if dtype == "float64":
        with jax.enable_x64(True):
            jout, out, jstats, stats = _run_both(case, dtype, train_mode)
    else:
        jout, out, jstats, stats = _run_both(case, dtype, train_mode)
    assert out.shape == jout.shape
    scale = np.abs(jout).max()
    assert scale > 0.1  # the redrawn head is not trivial
    np.testing.assert_allclose(out, jout, rtol=rtol, atol=rtol * scale)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(),
                                   rtol=stats_rtol, atol=stats_rtol / 10,
                                   err_msg=k)
    return out


@pytest.mark.parametrize("train_mode", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_logits_and_batch_stats_match_jax(case, train_mode):
    deep = train_mode and case.startswith("resnet50")
    out = _assert_match(case, "float32", train_mode,
                        FP32_DEEP_TRAIN_TOL if deep else 1e-5,
                        FP32_DEEP_TRAIN_TOL if deep else 1e-5)
    assert out.dtype == np.float32


@pytest.mark.parametrize("case", ["resnet50_32", "resnet50_33"])
def test_float64_training_forward_matches_jax(case):
    # The logits come out fp32 on both sides (flax's astype(float32)).
    _assert_match(case, "float64", True, 1e-9, 1e-9)


@pytest.mark.parametrize("case,train_mode", [
    ("resnet18_16", True), ("resnet18_16", False), ("resnet50_32", False),
], ids=["resnet18_16-train", "resnet18_16-eval", "resnet50_32-eval"])
def test_bf16_logits_and_batch_stats_match_jax(case, train_mode):
    """ResNet-50's training forward is left out in bf16: the amplification
    that costs fp32 2e-4 turns bf16's rounding (4e-3) into logits that
    differ at their own scale on either side."""
    jout, out, jstats, stats = _run_both(case, "bfloat16", train_mode)
    assert out.dtype == np.float32
    scale = np.abs(jout).max()
    np.testing.assert_allclose(out / scale, jout / scale, **BF16_TOL)
    for k, v in jstats.items():
        # fp32 statistics of bf16 conv outputs
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(), **BF16_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (55, 1, 2, (0, 0)), (33, 7, 2, (3, 3)),
    (9, 3, 2, (1, 1)), (16, 3, 1, (1, 1)),
])
def test_same_padding_is_flax_s(n, k, s, want):
    assert same_pads(n, k, s) == want
    x = jnp.zeros((1, n, n, 1))
    y = jax.lax.conv_general_dilated(
        x, jnp.zeros((k, k, 1, 1)), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert y.shape[1] == (n + sum(want) - k) // s + 1


def test_parameter_names_follow_the_flax_tree():
    name, kw, size = CASES["resnet50_32"]
    _, variables = _jax_variables(name, kw, size, jnp.float32)
    variables = jax.tree.map(np.asarray, variables)
    model = models.get_model(name, **kw)
    flat = weights.to_torch_layout(weights.from_jax_params(
        variables["params"]), set(model.state_dict()))
    assert set(flat) == {k for k, _ in model.named_parameters()}
    assert set(weights.from_jax_params(variables["batch_stats"])) == {
        k for k, _ in model.named_buffers()}
    assert model.BottleneckBlock_0.ConvBN_3.Conv_0.weight.shape == (
        16, 4, 1, 1)  # the projection of the first block
    assert not hasattr(model.BottleneckBlock_1, "ConvBN_3")
    assert model.ConvBN_0.Conv_0.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_init_is_flax_s_in_distribution():
    model = models.get_model("resnet50", num_classes=10, width=16)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.BottleneckBlock_4.ConvBN_1.Conv_0.weight  # 3x3, 32 in
    std = np.sqrt(2.0 / (9 * 32))
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / .87962566103423978 + 1e-6
    assert not model.Dense_0.weight.any() and not model.Dense_0.bias.any()
    bn = model.ConvBN_0.BatchNorm_0
    assert bool((bn.scale == 1).all() and (bn.bias == 0).all())
    assert bool((bn.mean == 0).all() and (bn.var == 1).all())


def test_remat_is_refused_by_name():
    """Remat is ported (``tests/test_torch_remat.py`` holds its numerics):
    'full' builds, an unknown mode is refused by name."""
    assert models.get_model("resnet50", remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat must be one of"):
        models.get_model("resnet50", remat="everything")


def test_running_statistics_survive_the_compute_copy():
    """Under the bf16 policy the step runs on a bf16 copy of the params
    (``functional_call``); the BatchNorm buffers it updates are the
    module's own fp32 ones."""
    model = models.get_model("resnet18", num_classes=10, width=8,
                             dtype="bfloat16")
    trainer = train.Trainer(model, train.make_optimizer("sgd", 0.1),
                            train.get_task("classification"), device="cpu",
                            precision="bf16")
    state = trainer.init(0)
    mean = state.model_state["ConvBN_0.BatchNorm_0.mean"]
    assert mean.dtype == torch.float32 and not mean.any()
    batch = {"image": torch.randn(8, 16, 16, 3),
             "label": torch.randint(0, 10, (8,))}
    state, _ = trainer.train_step(state, batch)
    assert mean.abs().sum() > 0
    assert mean is dict(model.named_buffers())["ConvBN_0.BatchNorm_0.mean"]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_loss_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, (16,)).astype(np.int32)
    labels[:4] = logits[:4].argmax(-1)  # some right answers
    _, jm = jax_train.classification_task(smoothing).loss_fn(
        jnp.asarray(logits), {"label": jnp.asarray(labels)})
    task = train.get_task("classification", label_smoothing=smoothing,
                          head_chunk=128)
    loss, m = task.loss_fn(torch.from_numpy(logits),
                           {"label": torch.from_numpy(labels)})
    assert set(m) == set(jm) == {"loss", "xent", "accuracy"}
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert (loss.item() > m["xent"].item()) == bool(smoothing)
    assert task.input_fn({"image": 1, "label": 2}) == (1,)


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["noclip", "clip"])
def test_sgd_matches_optax(clip):
    """10 updates of ``SGD`` and of the JAX factory's optax chain from the
    same params and gradients: cosine with 3 warmup steps over 10, weight
    decay on the matrices only, momentum 0.9, and a clip the gradients
    cross."""
    rng = np.random.default_rng(0)
    shapes = {"k": (4, 3, 3, 2), "w": (5, 6), "b": (6,), "scale": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 0.3
              for k, s in shapes.items()} for _ in range(10)]
    hp = dict(momentum=0.9, weight_decay=0.05, warmup_steps=3,
              schedule="cosine", total_steps=10, grad_clip=clip)
    tx = jax_train.make_optimizer("sgd", 0.2, **hp)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
    opt = train.make_optimizer("sgd", 0.2, **hp)
    assert isinstance(opt, train.SGD)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           state, params)
    assert state.count == 10
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    trace = weights._find_node(js, ("trace",)).trace
    for k in params:
        np.testing.assert_allclose(state.trace[k].numpy(),
                                   np.asarray(trace[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_zero1_over_sgd_is_refused_by_name():
    """ZeRO-1 of SGD's trace is ported: over dp=2 the trainer cuts the
    trace into this rank's shard of each group (held against JAX's
    ``zero1=True`` in ``tests/test_torch_grad_comm.py``)."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroSGDState

    mesh = Mesh({"dp": 2})
    model = models.get_model("resnet18", width=8, mesh=mesh)
    trainer = train.Trainer(model, train.make_optimizer("sgd"),
                            train.get_task("classification"), device="cpu",
                            mesh=mesh, zero1=True)
    opt = trainer.tx.init_shard(trainer.layout)
    assert isinstance(opt, ZeroSGDState)
    whole = sum(p.numel() for p in model.parameters())
    assert whole / 2 <= sum(t.numel() for t in opt.trace.values()) \
        <= whole / 2 + 16
