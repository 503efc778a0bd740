"""The port's ViT against the JAX package's ``models/vit.py``.

A small ViT at head_dim 64 (embed 128, 2 heads, 2 layers, 96² images,
patch 8): 145 tokens, so the flash route pads the sequence to 256 and
hides the 111 padded columns with its static limit, the path ViT-L/16's
197 tokens take on the card. On the CPU the port's flash wrappers run
their plain versions, the JAX flash kernel runs in Pallas interpret mode.

- Forward: the JAX init's tree with every leaf redrawn from a seeded numpy
  generator (no logit trivially zero), carried across by
  ``weights.from_jax_params``; fp32 logits within 1e-5 on the xla and the
  flash cores.
- remat 'none', 'full' and 'dots' give the port equal logits and
  gradients.
- Training: ``configs/vit_imagenet21k.py`` cut to that size (fp32, flash,
  the fused AdamW, remat 'full') trains 5 steps from the JAX Trainer's
  init and optimizer state, in the JAX Trainer and through the port's
  ``cli.build_all``: losses within 1e-4 relative, params within 1e-5.
  Adam's first update of a leaf is ``lr * sign(g)``, so an element whose
  gradient is at rounding level (one of 65536 in ``fc_out``: 2e-8 against
  a median of 1e-4) moves by +-lr differently on the two sides; at the
  config's lr of 1e-3 that is 1.3e-5, so the run uses lr 1e-4, and a
  second run at 1e-3 excuses that element alone.
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, models, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    opt_state_from_jax,
)

jax_data = importlib.import_module("distributeddeeplearning_tpu.data")
jax_models = importlib.import_module("distributeddeeplearning_tpu.models")
jax_train = importlib.import_module("distributeddeeplearning_tpu.train")

torch.set_num_threads(4)

CONFIG = "distributeddeeplearning_tpu_torch/configs/vit_imagenet21k.py"
SMALL = dict(size="tiny", num_layers=2, num_heads=2, embed_dim=128,
             patch_size=8, num_classes=10)
IMAGE = 96  # (96 / 8)² + 1 = 145 tokens
STEPS = 5
TRAIN = [
    "model.kwargs.size=tiny", "model.kwargs.num_layers=2",
    "model.kwargs.num_heads=2", "model.kwargs.embed_dim=128",
    "model.kwargs.patch_size=8", f"model.kwargs.image_size={IMAGE}",
    "model.kwargs.num_classes=10", "model.kwargs.dtype=float32",
    f"data.image_size={IMAGE}", "data.num_classes=10", "data.batch_size=4",
    "data.n_distinct=2", "optim.lr=1e-4", "optim.warmup_steps=2",
    f"train.steps={STEPS}",
]


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


@pytest.fixture(scope="module")
def weights_and_images():
    """A JAX init's tree, every leaf redrawn from a seeded generator
    (LayerNorm scales near one), and a batch of images."""
    jm = jax_models.get_model("vit", **SMALL)
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    params = _host(jm.init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.default_rng(0)

    def redraw(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return (1.0 + 0.1 * noise) if name == "scale" else 0.05 * noise

    params = jax.tree_util.tree_map_with_path(redraw, params)
    images = rng.standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    return params, images


def _port(params, **kw):
    m = models.get_model("vit", **SMALL, image_size=IMAGE, **kw)
    m.load_state_dict(from_jax_params(params), strict=True)
    return m


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_fp32_logits_match_jax(weights_and_images, attn_impl):
    params, images = weights_and_images
    jm = jax_models.get_model("vit", **SMALL, attn_impl=attn_impl)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images)))
    got = _port(params, attn_impl=attn_impl)(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def _logits_and_grads(params, images, remat, attn_impl):
    m = _port(params, remat=remat, attn_impl=attn_impl)
    out = m(torch.from_numpy(images), train=True)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad((out * out).sum(), list(m.parameters()))
    return out.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_equal_logits_and_gradients(weights_and_images, remat,
                                                attn_impl):
    params, images = weights_and_images
    want_out, want_g = _logits_and_grads(params, images, "none", attn_impl)
    out, g = _logits_and_grads(params, images, remat, attn_impl)
    torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
    for k, v in want_g.items():
        assert v.abs().max() > 0, k
        torch.testing.assert_close(g[k], v, rtol=1e-5, atol=1e-7, msg=k)


def test_parameter_names_and_init_follow_the_flax_tree():
    m = models.get_model("vit", **SMALL, image_size=IMAGE)
    m.init_weights(torch.Generator().manual_seed(0))
    jm = jax_models.get_model("vit", **SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)))["params"]
    want = {k: tuple(v.shape) for k, v in from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        nn.meta.unbox(shapes))).items()}
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == want
    assert not m.head.kernel.any() and not m.cls_token.any()
    assert abs(m.pos_embed.std().item() / 0.02 - 1) < 0.05


def test_image_size_is_checked():
    m = models.get_model("vit", **SMALL, image_size=IMAGE)
    with pytest.raises(ValueError, match="images"):
        m(torch.zeros(1, 64, 64, 3))


def _five_steps(mesh1, lr):
    """5 steps of the config cut to the small size at ``lr``, remat
    'full', from the JAX Trainer's init, in both packages: (the port's
    losses, its final params, JAX's losses, JAX's final params)."""
    cfg = apply_overrides(load_config(CONFIG), TRAIN + [f"optim.lr={lr}"])
    assert cfg.train.remat == "full" and cfg.optim.name == "adamw_fused"
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    assert model.remat == "full" and model.attn_impl == "flash"
    o = cfg.optim
    jtx = jax_train.make_optimizer(
        o.name, o.lr, b1=o.b1, b2=o.b2, weight_decay=o.weight_decay,
        warmup_steps=o.warmup_steps, schedule=o.schedule,
        total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    jm = jax_models.get_model("vit", **SMALL, attn_impl="flash",
                              remat="full")
    jtrainer = jax_train.Trainer(jm, jtx, jax_train.get_task(
        "classification"), mesh1, donate=False)
    jds = jax_data.SyntheticImages(**cfg.data.dataset_kwargs())
    jstate = jtrainer.init(0, jds.batch(0))

    state = trainer.init(cfg.train.seed)
    model.load_state_dict(from_jax_params(_host(jstate.params)),
                          strict=True)
    state.opt_state = opt_state_from_jax(_host(jstate.opt_state),
                                         state.opt_state)
    j_losses = []
    for i in range(STEPS):
        jstate, m = jtrainer.train_step(jstate, jds.batch(i))
        j_losses.append(float(m["loss"]))
    state, hist = train.fit(trainer, state,
                            data.prefetch(dataset.iter_from(0), "cpu"),
                            steps=STEPS, log_every=1, log_fn=lambda m: None)
    assert j_losses[-1] < j_losses[0]
    params = {k: p.detach().numpy() for k, p in state.params.items()}
    want = {k: v.numpy()
            for k, v in from_jax_params(_host(jstate.params)).items()}
    return [r["loss"] for r in hist], params, j_losses, want


def test_trainer_matches_jax_for_five_steps(mesh1):
    """5 steps of the config cut to the small size, remat 'full', from the
    JAX Trainer's init: losses 1e-4 relative, params 1e-5."""
    losses, params, j_losses, want = _five_steps(mesh1, 1e-4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    for k, v in want.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_trainer_matches_jax_at_the_config_lr(mesh1):
    """The same 5 steps at the config's lr of 1e-3: losses 1e-4 relative,
    params 1e-5 but for the rounding-level elements of an ``fc_out``
    kernel, whose gradient (2e-8 against a median of 1e-4) Adam's
    sign-like first steps move by a share of lr either way on either side
    (1.3e-5 measured): at most one element a leaf, within 5e-5."""
    losses, params, j_losses, want = _five_steps(mesh1, 1e-3)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    for k, v in want.items():
        off = np.abs(params[k] - v) > 1e-5
        if k.endswith("mlp.fc_out.kernel"):
            assert off.sum() <= 1, (k, int(off.sum()))
            np.testing.assert_allclose(params[k], v, rtol=0, atol=5e-5,
                                       err_msg=k)
        else:
            assert not off.any(), (k, np.abs(params[k] - v).max())
