"""The port's optimizers against the JAX package's.

``fused_adamw(...).update`` of the JAX package (its Pallas kernel in
interpret mode, as the JAX tests run it on the CPU) and the port's
``FusedAdamW.update`` (the plain version, which the wrapper runs for CPU
tensors) take the same numpy params and grads over a GPT-2-tiny-shaped tree
with a 1536-element bias (kernel-sized, undecayed), for three steps of a
warmup-cosine schedule; params and moments agree within 1e-6. The same
holds for ``make_optimizer('adamw')`` (optax) against the port's plain
AdamW. The decay mask and the plain/kernel split equal JAX's leaf for leaf,
at the tiny and at the 124M shapes. The CUDA kernel is held against the
plain version bit for bit on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""

import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu import train as jax_train
from distributeddeeplearning_tpu_torch import models, train
from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused
from distributeddeeplearning_tpu_torch.weights import (
    _find_adam_moments,
    from_jax_params,
    opt_state_from_jax,
)

jfused = importlib.import_module("distributeddeeplearning_tpu.ops.fused_adamw")

torch.set_num_threads(2)

_TINY = dict(size="tiny", vocab_size=256, max_len=64)


def _tree(seed):
    """GPT-2 tiny's parameter shapes as a nested dict, plus a kernel-sized
    undecayed bias, filled from ``seed``."""
    rng = np.random.default_rng(seed)
    tm = models.get_model("gpt2", **_TINY, device="meta")
    tree = {}
    shapes = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    shapes["extra.bias"] = (1536,)
    for name, shape in shapes.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return tree


def _as_torch(tree):
    return {k: v.clone() for k, v in from_jax_params(tree).items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _opts(name, wd, clip):
    return dict(name=name, lr=1e-2, b2=0.95, weight_decay=wd,
                warmup_steps=1, schedule="cosine", total_steps=4,
                grad_clip=clip)


def _run_both(name, wd, clip, steps=3):
    o = _opts(name, wd, clip)
    jtx = jax_train.make_optimizer(o.pop("name"), o.pop("lr"), **o)
    o = _opts(name, wd, clip)
    ttx = train.make_optimizer(o.pop("name"), o.pop("lr"), **o)
    params = _tree(0)
    jp, tp = params, _as_torch(params)
    js = jtx.init(jp)
    ts = opt_state_from_jax(_np(js), ttx.init(tp))
    for step in range(steps):
        # Large enough that the global-norm clip at 1.0 engages.
        grads = jax.tree.map(lambda x: x * (step + 1.0), _tree(10 + step))
        upd, js = jtx.update(grads, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.update(_as_torch(grads), ts, tp)
    return _np(jp), _np(js), tp, ts


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("wd", [0.1, 0.0])
@pytest.mark.parametrize("name", ["adamw_fused", "adamw"])
def test_update_matches_jax(name, wd, clip):
    jp, js, tp, ts = _run_both(name, wd, clip)
    adam = _find_adam_moments(js)
    assert ts.count == int(adam.count) == 3
    for want, got in ((jp, tp), (adam.mu, ts.mu), (adam.nu, ts.nu)):
        flat = from_jax_params(want)
        assert set(flat) == set(got)
        for k in flat:
            np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_gpt2_params(size_kw):
    jm = jax_models.get_model("gpt2", **size_kw)
    abstract = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return nn.meta.unbox(abstract["params"])


@pytest.mark.parametrize("size_kw", [_TINY, dict(size="124m")],
                         ids=["tiny", "124m"])
def test_decay_mask_and_split_equal_jax_leaf_for_leaf(size_kw):
    """The JAX tree's decay_leaf and size split against the port's
    parameters of the same model (abstract shapes on both sides)."""
    jparams = _jax_gpt2_params(size_kw)
    flat = {}

    def visit(path, leaf):
        flat[".".join(p.key for p in path)] = leaf

    jax.tree_util.tree_map_with_path(visit, jparams)
    tm = models.get_model("gpt2", **size_kw, device="meta")
    tparams = dict(tm.named_parameters())
    assert set(flat) == set(tparams)
    assert {k: bool(jfused.decay_leaf(v)) for k, v in flat.items()} == {
        k: fused.decay_leaf(p) for k, p in tparams.items()}
    plain, groups = fused.split_leaves(tparams, 0.1)
    j_plain = {k for k, v in flat.items()
               if np.prod(v.shape) < jfused._MIN_KERNEL_SIZE}
    assert {k for k, _ in plain} == j_plain
    j_groups = {}
    for k, v in flat.items():
        if k not in j_plain:
            wd = 0.1 if jfused.decay_leaf(v) else 0.0
            j_groups.setdefault(wd, set()).add(k)
    assert {wd: set(names) for (_, wd), names in groups.items()} == j_groups
    if size_kw.get("size") == "124m":
        # Two launches per step: 74 decayed matrices, 12 [3072] MLP biases.
        assert sorted(len(v) for v in groups.values()) == [12, 74]
        assert sum(tparams[n].numel() for v in groups.values()
                   for n in v) == 124_355_328
        # q/k/v biases are [12, 64]: decayed, but 768 elements -> plain.
        assert ("h.block_0.attn.query.bias", 0.1) in plain


OPTAX_SCHEDULES = {
    # What the JAX package's make_optimizer builds for each name.
    "constant": lambda lr, w, t: optax.constant_schedule(lr),
    "cosine": lambda lr, w, t: optax.warmup_cosine_decay_schedule(
        0.0, lr, w, max(t, w + 1)),
    "linear": lambda lr, w, t: optax.join_schedules(
        [optax.linear_schedule(0.0, lr, max(w, 1)),
         optax.linear_schedule(lr, 0.0, max(t - w, 1))], [w]),
}


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", list(OPTAX_SCHEDULES))
def test_schedules_match_optax(schedule, warmup):
    want = OPTAX_SCHEDULES[schedule](6e-4, warmup, 10)
    tx = train.make_optimizer("adamw_fused", 6e-4, warmup_steps=warmup,
                              schedule=schedule, total_steps=10)
    for count in range(13):
        np.testing.assert_allclose(
            float(tx.learning_rate(count)),
            float(want(jnp.asarray(count, jnp.int32))),
            rtol=1e-6, atol=1e-12, err_msg=f"count {count}")


def test_clip_matches_reference():
    g = _tree(3)
    want = jfused._clip_by_global_norm(g, 0.5)
    got = fused.clip_by_global_norm(_as_torch(g), 0.5)
    for k, v in from_jax_params(_np(want)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_group_wrapper_on_cpu_is_plain_and_launches_nothing():
    rng = np.random.default_rng(4)
    t = [torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32))
         for _ in range(4)]
    t[3] = t[3].abs()
    ref = [x.clone() for x in t]
    hp = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=10.0, c2=20.0)
    before = fused.LAUNCHES["fused_adamw"]
    fused.fused_adamw_group([t[0]], [t[1]], [t[2]], [t[3]], **hp)
    fused.fused_adamw_plain(*ref, **hp)
    assert fused.LAUNCHES["fused_adamw"] == before
    for a, b in zip(t, ref):
        assert torch.equal(a, b)


def test_refused_optimizers_and_policies_by_name():
    # sgd is ported with ResNet; its low-precision moments are refused as
    # the reference refuses them.
    assert isinstance(train.make_optimizer("sgd", 0.1), train.SGD)
    with pytest.raises(ValueError, match="optim.name='sgd'"):
        train.make_optimizer("sgd", 0.1, precision="bf16_full")
    with pytest.raises(NotImplementedError, match="bf16_full"):
        train.make_optimizer("adamw", 0.1, precision="bf16_full")
    with pytest.raises(ValueError, match="adamw_fused"):
        train.make_optimizer("adamw_fused", 0.1, precision="bf16_full")
