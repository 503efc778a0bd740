"""Activation checkpointing (remat) in the port: the numerics must not
change (the JAX package's ``tests/test_remat.py``), and the state that
lives outside a checkpointed block must not see the recompute.

- ResNet-18 trained 4 steps under remat 'none', 'full' and 'dots': equal
  losses (rtol 1e-5), and equal BatchNorm running statistics: a recompute
  that moved them again would apply the momentum twice.
- GPT-2 at dropout 0.1 under remat 'full' and 'dots' against 'none' from
  one generator seed: equal losses and gradients, which needs the
  recompute to draw the forward's dropout masks from the explicit
  generator. (Port against port: JAX's masks come from ``fold_in`` keys,
  which a torch generator cannot replay.)
- The 'dots' policy saves the products without batch dims (``mm``,
  ``addmm``, and ``bmm`` over a batch of one) and nothing else; under it
  the backward runs no forward ``addmm`` again, under 'full' it does.
- The flash forward runs again in every block's recompute under either
  policy (its kernel launch is no dispatched op), and the generator ends a
  step where it would without remat.
- ``cli`` applies ``train.remat`` to the model; the two encoder configs
  are the JAX package's, field for field.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributeddeeplearning_tpu_torch import cli, config, data, models, train
from distributeddeeplearning_tpu_torch.models import remat as remat_lib
from distributeddeeplearning_tpu_torch.ops import flash_attention

jax_config = importlib.import_module("distributeddeeplearning_tpu.config")

torch.set_num_threads(4)

MODES = ("none", "full", "dots")


def _resnet_run(remat: str, n_steps: int = 4):
    model = models.get_model("resnet18", num_classes=10, width=8,
                             remat=remat)
    trainer = train.Trainer(model, train.make_optimizer("sgd", 0.05),
                            train.get_task("classification"), device="cpu")
    state = trainer.init(0)
    ds = data.SyntheticImages(batch_size=16, image_size=16, num_classes=10,
                              seed=0, n_distinct=4)
    losses = []
    for i in range(n_steps):
        state, m = trainer.train_step(state, data.to_device(ds.batch(i),
                                                            "cpu"))
        losses.append(float(m["loss"]))
    return losses, {k: b.clone() for k, b in state.model_state.items()}


@pytest.fixture(scope="module")
def resnet_runs():
    return {mode: _resnet_run(mode) for mode in MODES}


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_resnet_remat_losses_match_none(resnet_runs, mode):
    np.testing.assert_allclose(resnet_runs[mode][0], resnet_runs["none"][0],
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_resnet_running_statistics_move_once(resnet_runs, mode):
    want = resnet_runs["none"][1]
    got = resnet_runs[mode][1]
    assert any((v != (1.0 if k.endswith("var") else 0.0)).any()
               for k, v in want.items())
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-7, msg=k)


def _gpt2(remat, attn_impl="xla", dropout_rate=0.1):
    m = models.get_model("gpt2", size="tiny", vocab_size=97, max_len=32,
                         dropout_rate=dropout_rate, remat=remat,
                         attn_impl=attn_impl)
    m.init_weights(torch.Generator().manual_seed(3))
    return m


def _gpt2_loss_and_grads(remat, attn_impl="xla", seed=11):
    m = _gpt2(remat, attn_impl)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 97, (2, 17)))
    gen = torch.Generator().manual_seed(seed)
    out = m(tokens[:, :-1], train=True, generator=gen)
    loss = torch.nn.functional.cross_entropy(out.reshape(-1, 97),
                                             tokens[:, 1:].reshape(-1))
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return loss.detach(), dict(zip(names, grads)), gen.get_state()


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_gpt2_dropout_under_remat_matches_none(mode):
    want_loss, want_g, want_gen = _gpt2_loss_and_grads("none")
    loss, g, gen = _gpt2_loss_and_grads(mode)
    assert torch.equal(loss, want_loss)
    for k, v in want_g.items():
        torch.testing.assert_close(g[k], v, rtol=1e-6, atol=1e-8, msg=k)
    # The generator ends where it would without remat.
    assert torch.equal(gen, want_gen)
    # The masks are live: another seed gives another loss.
    assert not torch.equal(_gpt2_loss_and_grads("none", seed=12)[0],
                           want_loss)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", MODES)
def test_dots_saves_the_products_full_recomputes_them(mode):
    """Each GPT-2 block runs 6 biased Dense products (``addmm``) forward;
    the backward of a product runs ``mm`` only. So the ``addmm`` the
    backward runs are recomputed products: some under 'full', none under
    'dots' (saved) or 'none'."""
    m = _gpt2(mode, dropout_rate=0.0)
    tokens = torch.randint(0, 97, (2, 16), generator=torch.Generator()
                           .manual_seed(0))
    loss = m(tokens).float().square().mean()
    with _CountOps() as ops:
        loss.backward()
    recomputed = ops.counts.get(torch.ops.aten.addmm.default, 0)
    assert (recomputed > 0) == (mode == "full"), recomputed


def test_dots_policy_keys_on_the_shape():
    aten = torch.ops.aten
    a, b = torch.ones(1, 2, 3), torch.ones(1, 3, 4)
    saved = remat_lib.CheckpointPolicy.MUST_SAVE
    assert remat_lib._dots_policy(None, aten.mm.default) is saved
    assert remat_lib._dots_policy(None, aten.addmm.default) is saved
    assert remat_lib._dots_policy(None, aten.bmm.default, a, b) is saved
    assert remat_lib._dots_policy(
        None, aten.bmm.default, torch.ones(2, 2, 3), torch.ones(2, 3, 4)
    ) is not saved
    assert remat_lib._dots_policy(None, aten.add.Tensor, a, a) is not saved


@pytest.mark.parametrize("mode,forwards", [("none", 2), ("full", 4),
                                           ("dots", 4)])
def test_flash_forward_reruns_in_the_recompute(monkeypatch, mode, forwards):
    calls = []
    real = flash_attention.flash_fwd

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_attention, "flash_fwd", counting)
    m = _gpt2(mode, attn_impl="flash", dropout_rate=0.0)
    tokens = torch.randint(0, 97, (2, 16), generator=torch.Generator()
                           .manual_seed(0))
    m(tokens, train=True).float().square().mean().backward()
    assert len(calls) == forwards  # 2 layers, twice under remat


def test_unknown_remat_mode_is_refused():
    with pytest.raises(ValueError, match="remat must be one of"):
        models.get_model("vit", size="tiny", image_size=16, remat="some")


@pytest.mark.parametrize("name,remat", [("resnet18_cifar10", "dots"),
                                        ("gpt2_owt", "full")])
def test_cli_applies_train_remat(name, remat):
    path = f"distributeddeeplearning_tpu_torch/configs/{name}.py"
    overrides = [f"train.remat={remat}"]
    if name == "gpt2_owt":
        overrides += ["model.kwargs.size=tiny", "model.kwargs.vocab_size=97",
                      "model.kwargs.max_len=32", "data.seq_len=32",
                      "data.vocab_size=97"]
    cfg = config.apply_overrides(config.load_config(path), overrides)
    model, _, _ = cli.build_all(cfg, "cpu")
    assert model.remat == remat


@pytest.mark.parametrize("name", ["vit_imagenet21k", "bert_mlm"])
def test_configs_are_the_jax_package_s(name):
    ours = config.load_config(
        f"distributeddeeplearning_tpu_torch/configs/{name}.py")
    theirs = jax_config.load_config(f"configs/{name}.py")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
