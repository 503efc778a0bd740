"""The port's MoE routing and models against the JAX package's
``parallel/ep.py`` and ``models/moe.py``.

On the CPU, where the port's flash wrappers run their plain versions and
JAX's flash kernel runs in Pallas interpret mode; every input comes from a
seeded numpy generator:

- ``route_top_k``: dispatch and combine equal JAX's exactly, with ample
  capacity, capacity 1 (drops), top-1 and tied probabilities (the lower
  index first); the aux loss, a float reduction over the tokens in another
  order, within 1e-6 relative; the gates' gradient against ``jax.grad``;
  ``expert_capacity`` and ``check_moe_shapes``;
- ``MoeMlp``, both styles: the routing compared first (the top-k indices,
  with the smallest margin between a kept and a passed-over probability
  printed, so a flip shows as a flip), then fp32 within 1e-5, bf16 within
  two bf16 roundings of JAX's bf16, and the sown aux loss and dropped
  fraction; the one-hot FLOPs the benchmark reports against
  ``FlopCounterMode``;
- ``MoeGPT2`` and ``LlamaMoe``: the parameter names and shapes are the
  flax tree's, and the fp32 logits within 1e-5 of JAX's on the xla and
  flash cores with the chunked head on and off;
- 5 steps of ``configs/gpt2_moe.py`` and ``configs/llama_moe.py`` cut to
  the tiny size, from the JAX Trainer's init and Adam state, in both
  Trainers: losses within 1e-4 relative, ``aux_loss`` and
  ``moe_dropped_frac`` within 1e-5, params within 1e-5, the router kernel
  moved; ``evaluate`` against JAX's, with no ``aux_loss``;
- remat 'full' equals 'none' for ``LlamaMoe`` with the aux loss counted
  once; ``grad_accum=2`` equals 1; dp=2 over two gloo processes equals one
  process within 2e-5 (routing is per row);
- the refusals by name (``gpt2_moe`` with remat, with the reference's
  message; ``LlamaMoe`` 'dots'; serving), MoE x cp=2 and ep=2 taken (held
  against JAX in ``tests/test_torch_ep.py``), ``cli train``,
  ``cli eval`` and ``cli benchmark`` on both configs at the tiny size, and
  both configs equal the JAX package's field for field.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import socket

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import cli as jax_cli
from distributeddeeplearning_tpu import config as jax_config
from distributeddeeplearning_tpu import data as jax_data
from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu.models import moe as jax_moe
from distributeddeeplearning_tpu.parallel import ep as jax_ep
from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
from distributeddeeplearning_tpu.train import evaluate as jax_evaluate
from distributeddeeplearning_tpu.train import get_task as jax_get_task
from distributeddeeplearning_tpu.train import make_optimizer as jax_make_opt
from distributeddeeplearning_tpu_torch import cli, data, models, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.models import moe, sow
from distributeddeeplearning_tpu_torch.parallel import ep
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    opt_state_from_jax,
)

torch.set_num_threads(2)

CONFIGS = {
    "gpt2_moe": "distributeddeeplearning_tpu_torch/configs/gpt2_moe.py",
    "llama_moe": "distributeddeeplearning_tpu_torch/configs/llama_moe.py",
}
KW = dict(size="tiny", vocab_size=256, max_len=64)
TOKENS = np.random.default_rng(0).integers(0, 256, (2, 17), np.int32)
# Each config at the tiny size, fp32, a schedule short enough to move.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=64", "data.batch_size=4",
    "data.n_distinct=2", "optim.lr=1e-3", "optim.warmup_steps=2",
    "train.steps=5", "train.head_chunk=16",
]
STEPS = 5


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _cfg(name, *overrides):
    return apply_overrides(load_config(CONFIGS[name]), TINY + list(overrides))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _probs(g, t, e, seed=0):
    logits = np.random.default_rng(seed).standard_normal((g, t, e))
    return np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


ROUTES = {
    # (g, t, e, k, capacity factor)
    "ample": (2, 16, 4, 2, 2.0),
    "default": (3, 33, 8, 2, 1.25),
    "capacity_1": (2, 16, 4, 2, 0.1),
    "top1": (2, 16, 4, 1, 1.0),
}


def _ties(kind):
    g, t, e = 2, 16, 4
    if kind == "uniform":  # every choice a tie: lower index first
        return np.full((g, t, e), 0.25, np.float32), 2, 2.0
    # JAX's balanced case: cyclic nudges, then a tie in the second choice.
    probs = jnp.full((g, t, e), 1.0 / e) + 1e-6 * jax.nn.one_hot(
        jnp.arange(t) % e, e)[None]
    return np.array(probs, np.float32), 2, 1.0


def _route_both(probs, k, capacity):
    jd, jc, ja = jax_ep.route_top_k(jnp.asarray(probs), k, capacity)
    td, tc, ta, kept = ep.route_top_k(torch.from_numpy(probs), k, capacity)
    return (np.asarray(jd), np.asarray(jc), float(ja)), (td, tc, ta, kept)


@pytest.mark.parametrize("case", [*ROUTES, "tie_uniform", "tie_balanced"])
def test_route_top_k_matches_jax(case):
    if case.startswith("tie_"):
        probs, k, cf = _ties(case[4:])
    else:
        g, t, e, k, cf = ROUTES[case]
        probs = _probs(g, t, e, seed=len(case))
    g, t, e = probs.shape
    c = ep.expert_capacity(t, e, k, cf)
    assert c == jax_ep.expert_capacity(t, e, k, cf)
    (jd, jc, ja), (td, tc, ta, kept) = _route_both(probs, k, c)
    assert td.shape == (g, t, e, c)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert int(kept) == int(jd.sum())
    np.testing.assert_allclose(ta.item(), ja, rtol=1e-6)
    if case == "capacity_1":
        assert int(kept) == 2 * e  # one slot an expert and group
    if case == "tie_balanced":
        assert abs(ta.item() - 1.0) < 1e-3  # JAX's balanced-router check
    if case == "tie_uniform":
        # Every token's choices are experts 0 and 1, in that order.
        assert bool((td.sum(-1)[..., :2] == 1).all())
        assert not bool(td.sum(-1)[..., 2:].any())


def test_route_gate_gradient_matches_jax():
    probs = _probs(2, 16, 4, seed=5)
    w = np.random.default_rng(6).standard_normal(
        (2, 16, 4, ep.expert_capacity(16, 4, 2, 1.0))).astype(np.float32)
    c = w.shape[-1]

    def jax_obj(p):
        _, comb, aux = jax_ep.route_top_k(p, 2, c)
        return (comb * w).sum() + aux

    want = np.asarray(jax.grad(jax_obj)(jnp.asarray(probs)))
    p = torch.from_numpy(probs).requires_grad_()
    _, comb, aux, _ = ep.route_top_k(p, 2, c)
    ((comb * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [(16, 4, 2, 1.25), (2048, 8, 2, 1.25),
                                  (1024, 8, 2, 1.25), (17, 8, 2, 1.25),
                                  (16, 4, 1, 0.01), (7, 3, 2, 1.0)])
def test_expert_capacity_matches_jax(args):
    assert ep.expert_capacity(*args) == jax_ep.expert_capacity(*args)
    if args[:2] == (2048, 8):
        assert ep.expert_capacity(*args) == 640  # llama_moe's slots
    if args[:2] == (1024, 8):
        assert ep.expert_capacity(*args) == 320  # gpt2_moe's


def test_check_moe_shapes_raises_jax_s_error():
    with pytest.raises(ValueError) as jerr:
        jax_ep.check_moe_shapes(6, 4)
    with pytest.raises(ValueError) as err:
        ep.check_moe_shapes(6, 4)
    assert str(err.value) == str(jerr.value)
    ep.check_moe_shapes(8, 4)


# ---------------------------------------------------------------------------
# MoeMlp
# ---------------------------------------------------------------------------

MLP = dict(num_experts=8, hidden_dim=48, num_selected=2,
           capacity_factor=1.25)


@functools.lru_cache(maxsize=None)
def _mlp_params(style):
    """A JAX MoeMlp's tree (embed 32) with every leaf redrawn: the experts'
    0.1 x standard normal (outputs of order one), the router's 1.0, so the
    router's margins are wide."""
    jm = jax_moe.MoeMlp(**MLP, mlp_style=style, activation="gelu_tanh")
    x = jnp.zeros((3, 20, 32))
    params = _host(jm.init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (1.0 if path[0].key == "router" else 0.1)
        * rng.standard_normal(leaf.shape).astype(np.float32), params)


def _mlp_both(style, dtype):
    params = _mlp_params(style)
    x = np.random.default_rng(8).standard_normal((3, 20, 32)).astype(
        np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = jax_moe.MoeMlp(**MLP, mlp_style=style, activation="gelu_tanh",
                        dtype=jdt)
    want, sown = jm.apply({"params": params}, jnp.asarray(x, jdt),
                          mutable=["losses", "metrics"])
    tdt = getattr(torch, dtype)
    tm = moe.MoeMlp(32, 8, 48, tdt, mlp_style=style,
                    activation="gelu_tanh")
    tm.load_state_dict(from_jax_params(params), strict=True)
    with sow.collecting() as got_sown:
        got = tm(torch.from_numpy(x).to(tdt))
    # The routing first: the top-2 experts of every token, and how close
    # the nearest flip is.
    xr = jnp.asarray(jnp.asarray(x, jdt), jnp.float32)
    probs = np.asarray(jax.nn.softmax(xr @ params["router"]["kernel"], -1))
    order = np.argsort(-probs, -1, kind="stable")
    tprobs = torch.softmax(tm.router(torch.from_numpy(x).to(tdt).float()),
                           -1)
    _, tidx = ep.top_k_lower_index_first(tprobs, 2)
    np.testing.assert_array_equal(tidx.numpy(), order[..., :2])
    srt = np.sort(probs, -1)[..., ::-1]
    print(f"{style} {dtype}: smallest top-2 margin "
          f"{(srt[..., 1] - srt[..., 2]).min():.3g}, top-1 "
          f"{(srt[..., 0] - srt[..., 1]).min():.3g}")
    return (np.asarray(jnp.asarray(want, jnp.float32)), sown,
            got.detach().float().numpy(), got_sown)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("style", ["gelu", "swiglu"])
def test_moe_mlp_matches_jax(style, dtype):
    want, sown, got, got_sown = _mlp_both(style, dtype)
    assert np.abs(want).max() > 0.5
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # Both round the experts' products, activations and the combine to
        # bf16 (8 bits of mantissa): two bf16 roundings apart at most.
        np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2e-2)
    (name, aux), = got_sown.losses
    assert name == "moe_aux"
    (jaux,) = jax.tree.leaves(sown["losses"])
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    (jdrop,) = jax.tree.leaves(sown["metrics"])
    (drop,) = got_sown.metrics["moe_dropped_frac"]
    assert drop.item() == float(jdrop) and 0 < drop.item() < 1


def test_moe_mlp_sows_nothing_outside_a_collection():
    params = _mlp_params("swiglu")
    tm = moe.MoeMlp(32, 8, 48, torch.float32, mlp_style="swiglu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    with sow.collecting() as sown:
        pass
    tm(torch.zeros(1, 4, 32))
    assert sown.losses == [] and sown.metrics == {}


@pytest.mark.parametrize("style", ["gelu", "swiglu"])
def test_onehot_flops_match_flop_counter(style):
    """``onehot_flops`` is what ``FlopCounterMode`` counts for the one-hot
    einsums of a forward and backward: the total less the router's product
    (3 of 2·g·t·d·e) and the experts' (2 or 3 products, 3 each)."""
    from torch.utils.flop_counter import FlopCounterMode

    g, t, d, e, h = 3, 20, 32, 8, 48
    tm = moe.MoeMlp(d, e, h, torch.float32, mlp_style=style)
    tm.load_state_dict(from_jax_params(_mlp_params(style)), strict=True)
    x = torch.randn(g, t, d, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        tm(x).square().sum().backward()
    c = tm.capacity(t)
    experts = (3 if style == "swiglu" else 2) * 3 * 2 * e * g * c * d * h
    router = 3 * 2 * g * t * d * e
    assert counter.get_total_flops() - experts - router == moe.onehot_flops(
        tm, g, t)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _redrawn(name):
    """The JAX init's tree with every leaf redrawn from a seeded generator:
    norm scales near one, the rest 0.05 x standard normal."""
    jm = jax_models.get_model(name, **KW)
    params = _host(jm.init(jax.random.PRNGKey(0), TOKENS)["params"])
    rng = np.random.default_rng(1)

    def redraw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1.0 + 0.1 * noise
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(redraw, params)


def _port(name, params, **kw):
    m = models.get_model(name, **KW, **kw)
    m.load_state_dict(from_jax_params(params), strict=True)
    return m


def _logits(out):
    if isinstance(out, dict):
        return np.asarray(out["hidden"], np.float32) @ np.asarray(
            out["emb"], np.float32).T
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_parameter_names_and_init_follow_the_flax_tree(name):
    m = models.get_model(name, **KW)
    m.init_weights(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in from_jax_params(
        _redrawn(name)).items()}
    got = {k: tuple(p.shape) for k, p in m.named_parameters()}
    assert got == want
    blk = "block_1" if name == "gpt2_moe" else "block_0"
    assert want[f"{blk}.moe_mlp.router.kernel"] == (64, 8)
    w1 = m.get_submodule(f"{blk}.moe_mlp").w1
    assert abs(w1.std().item() / 0.02 - 1) < 0.05
    if name == "gpt2_moe":
        assert "block_0.mlp.fc_in.kernel" in got  # a dense block
        assert not m.block_1.moe_mlp.b1.any()
    else:
        assert "block_0.moe_mlp.w_gate" in got and "lm_head" in got


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_fp32_logits_match_jax(name, attn_impl, chunked):
    params = _redrawn(name)
    kw = dict(attn_impl=attn_impl, chunked_head=chunked)
    jm = jax_models.get_model(name, **KW, **kw)
    want, jsown = jm.apply({"params": params}, jnp.asarray(TOKENS),
                           mutable=["losses", "metrics"])
    with sow.collecting() as sown:
        got = _port(name, params, **kw)(torch.from_numpy(TOKENS))
    if chunked:
        assert set(got) == set(want) == {"hidden", "emb"}
        got = {k: v.detach().numpy() for k, v in got.items()}
    else:
        assert got.dtype == torch.float32 and got.shape == (2, 17, 256)
        got = got.detach()
    want, got = _logits(want), _logits(got)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jaux = jax.tree.leaves(jsown["losses"])
    assert len(sown.losses) == len(jaux) == (1 if name == "gpt2_moe" else 2)
    np.testing.assert_allclose([v.item() for _, v in sown.losses],
                               [float(a) for a in jaux], rtol=1e-6)
    assert [v.item() for v in sown.metrics["moe_dropped_frac"]] == [
        float(a) for a in jax.tree.leaves(jsown["metrics"])]


def test_bf16_logits_match_jax():
    params = _redrawn("llama_moe")
    want = np.asarray(jax_models.get_model(
        "llama_moe", **KW, dtype=jnp.bfloat16).apply(
            {"params": params}, jnp.asarray(TOKENS)), np.float32)
    got = _port("llama_moe", params, dtype="bfloat16")(
        torch.from_numpy(TOKENS))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2 ** -6,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# training against the JAX Trainer
# ---------------------------------------------------------------------------


def _jax_model_kwargs(cfg):
    return {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(init params, init opt state, per-step metrics, final params, eval)
    of the JAX Trainer on the tiny config."""
    cfg = _cfg(name)
    o = cfg.optim
    tx = jax_make_opt(o.name, o.lr, b1=o.b1, b2=o.b2,
                      weight_decay=o.weight_decay,
                      warmup_steps=o.warmup_steps, schedule=o.schedule,
                      total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    jm = jax_models.get_model(cfg.model.name, **_jax_model_kwargs(cfg))
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    mesh = single_device_mesh()
    jtrainer = JaxTrainer(jm, tx, jax_get_task("lm", head_chunk=16), mesh,
                          donate=False)
    jds = jax_data.SyntheticTokens(**cfg.data.dataset_kwargs())
    jstate = jtrainer.init(0, jds.batch(0))
    init = (_host(jstate.params), _host(jstate.opt_state))
    ev = jax_evaluate(jtrainer, jstate, jax_data.sharded_batches(
        (jds.batch(i) for i in range(2)), mesh))
    hist = []
    for batch in jax_data.sharded_batches(
            (jds.batch(i) for i in range(STEPS)), mesh):
        jstate, m = jtrainer.train_step(jstate, batch)
        hist.append({k: float(v) for k, v in m.items()})
    return init, hist, from_jax_params(_host(jstate.params)), ev


def _start(name, *overrides, mesh=None, init=None):
    """``init``: the JAX init's (params, opt state) as host arrays (default:
    ``_jax_run``'s, which runs the JAX Trainer here)."""
    cfg = _cfg(name, *overrides)
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    params, opt_state = init if init is not None else _jax_run(name)[0]
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(from_jax_params(params), strict=True)
    state.opt_state = opt_state_from_jax(opt_state, state.opt_state)
    return cfg, trainer, dataset, state


def _fit(name, *overrides, mesh=None, init=None):
    cfg, trainer, dataset, state = _start(name, *overrides, mesh=mesh,
                                          init=init)
    batches = data.prefetch(data.sharded_batches(
        dataset.iter_from(0), mesh, cfg.train.grad_accum), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=STEPS,
                            log_every=1, log_fn=lambda m: None)
    return hist, {k: p.detach().clone() for k, p in state.params.items()}


@functools.lru_cache(maxsize=None)
def _port_run(name, *overrides):
    return _fit(name, *overrides)


@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_trainer_matches_jax_for_five_steps(name):
    cfg = _cfg(name)
    assert cfg.optim.name == "adamw" and cfg.model.kwargs["attn_impl"] == (
        "flash")
    (params, _), j_hist, j_params, _ = _jax_run(name)
    hist, got = _port_run(name)
    assert j_hist[-1]["loss"] < j_hist[0]["loss"]
    for key in ("loss", "perplexity"):
        np.testing.assert_allclose([r[key] for r in hist],
                                   [r[key] for r in j_hist], rtol=1e-4)
    for key in ("aux_loss", "moe_dropped_frac"):
        np.testing.assert_allclose([r[key] for r in hist],
                                   [r[key] for r in j_hist], rtol=0,
                                   atol=1e-5, err_msg=key)
    assert all(r["moe_dropped_frac"] > 0 for r in hist)  # c = 20 of 64
    for k, v in j_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    router = "block_1.moe_mlp.router.kernel"
    init = from_jax_params(params)[router]
    assert (got[router] - init).abs().max() > 1e-4  # the router learns


def test_evaluate_matches_jax_without_aux_loss():
    *_, want = _jax_run("llama_moe")
    cfg, trainer, dataset, state = _start("llama_moe")
    got = train.evaluate(trainer, state, data.prefetch(
        (dataset.batch(i) for i in range(2)), "cpu"))
    assert set(got) == set(want) == {"eval_loss", "eval_perplexity"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_grad_accum_2_equals_1():
    one, p_one = _port_run("llama_moe")
    two, p_two = _port_run("llama_moe", "train.grad_accum=2")
    for key in ("loss", "aux_loss", "moe_dropped_frac"):
        np.testing.assert_allclose([r[key] for r in two],
                                   [r[key] for r in one], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    for k, v in p_one.items():
        np.testing.assert_allclose(p_two[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def _grads(remat):
    m = _port("llama_moe", _redrawn("llama_moe"), remat=remat,
              attn_impl="flash")
    with sow.collecting() as sown:
        out = m(torch.from_numpy(TOKENS), train=True)
        loss = (out * out).mean() + sum(v for _, v in sown.losses)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
    return loss.detach(), dict(zip(names, grads)), len(sown.losses)


def test_remat_full_equals_none_with_aux_counted_once():
    want_loss, want_g, n_none = _grads("none")
    loss, g, n_full = _grads("full")
    assert n_none == n_full == 2  # the recompute sowed nothing
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-7)
    for k, v in want_g.items():
        assert v.abs().max() > 0, k
        torch.testing.assert_close(g[k], v, rtol=1e-5, atol=1e-7, msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_worker(rank, port, out_dir, init):
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.mesh import (
        build_mesh,
        init_distributed,
    )

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    with contextlib.redirect_stdout(io.StringIO()):
        assert init_distributed("cpu")
    cfg = _cfg("gpt2_moe")
    assert cfg.train.zero1  # ZeRO-1 of the plain AdamW's moments at dp=2
    out = _fit("gpt2_moe", mesh=build_mesh(cfg.mesh), init=init)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_dp2_over_gloo_matches_one_process(tmp_path):
    """2 ranks, 2 rows each: each rank routes and averages its own rows'
    aux loss and dropped fraction; the mean over the ranks is the one
    process's, within JAX's EP parity tolerance."""
    # The ranks start from the parent's JAX init (no JAX run in a rank).
    ctx = torch.multiprocessing.spawn(_dp_worker, args=(
        _free_port(), str(tmp_path), _jax_run("gpt2_moe")[0]), nprocs=2,
        join=False)
    one, p_one = _port_run("gpt2_moe")  # while the ranks run
    while not ctx.join():
        pass
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    hist, params = ranks[0]
    for a, b in zip(hist, ranks[1][0]):
        a, b = dict(a), dict(b)
        assert a.pop("wall_s") > 0 and b.pop("wall_s") > 0
        assert a == b
    for key in ("loss", "aux_loss", "moe_dropped_frac"):
        np.testing.assert_allclose([r[key] for r in hist],
                                   [r[key] for r in one], rtol=2e-5,
                                   atol=1e-7, err_msg=key)
    for k, v in p_one.items():
        assert torch.equal(ranks[1][1][k], params[k]), k
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# fences, the CLI and the configs
# ---------------------------------------------------------------------------


def test_gpt2_moe_remat_is_refused_with_the_reference_message():
    jcfg = jax_config.apply_overrides(
        jax_config.load_config("configs/gpt2_moe.py"),
        [o for o in TINY if "dtype" not in o] + ["train.remat=full"])
    with pytest.raises(ValueError) as jerr:
        jax_cli.build_all(jcfg)
    with pytest.raises(ValueError) as err:
        cli.build_all(_cfg("gpt2_moe", "train.remat=full"), "cpu")
    assert str(err.value) == str(jerr.value) == (
        "model 'gpt2_moe' does not support remat")


def test_llama_moe_remat_dots_is_refused_with_the_reference_message():
    with pytest.raises(ValueError) as jerr:
        jax_models.get_model("llama_moe", **KW, remat="dots").init(
            jax.random.PRNGKey(0), TOKENS)
    with pytest.raises(ValueError) as err:
        cli.build_all(_cfg("llama_moe", "train.remat=dots"), "cpu")
    assert str(err.value) == str(jerr.value) == "unknown remat 'dots'"
    assert cli.build_all(_cfg("llama_moe", "train.remat=full"),
                         "cpu")[0].remat == "full"


def test_moe_over_cp_is_refused_by_name():
    """Once refused, now ported: the Trainer takes an MoE model over cp
    (its routing carries the counts of the other blocks of a row,
    ``parallel.ep.route_top_k``; held against JAX in
    ``tests/test_torch_ep.py``), averaging over every rank."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    mesh = Mesh({"cp": 2})
    m = models.get_model("llama_moe", **KW, attn_impl="ring", mesh=mesh)
    trainer = train.Trainer(m, train.AdamW(1e-3),
                            train.get_task("lm", mesh=mesh), device="cpu",
                            mesh=mesh)
    assert trainer.sync_axis == "world" and trainer.shards is None


@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_ep_and_serving_are_refused_by_name(name):
    """``mesh.ep`` is ported (``tests/test_torch_ep.py``): the composition
    check passes it; capacity-MoE serving is still refused by name."""
    from distributeddeeplearning_tpu_torch.serving import (
        check_serving_composition,
    )

    cli.check_train_composition(_cfg(name, "mesh.ep=2", "mesh.dp=1"),
                                world_size=2)
    cli.check_train_composition(_cfg(name, "mesh.ep=4", "mesh.dp=2"),
                                world_size=8)
    with pytest.raises(NotImplementedError, match="capacity-MoE"):
        check_serving_composition(_cfg(name))


def _main(name, cmd, *overrides):
    argv = [cmd, "--config", CONFIGS[name], "--device", "cpu"]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_cli_train_eval_and_benchmark(name, tmp_path):
    extra = ["train.steps=2", "train.log_every=1", "train.save_every=2",
             f"train.checkpoint_dir={tmp_path}", "train.eval_batches=1",
             "model.kwargs.dtype=bfloat16", "train.precision.policy=bf16"]
    recs = [json.loads(x) for x in _main(name, "train", *extra)
            if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(math.isfinite(r[k]) for k in ("loss", "aux_loss",
                                                  "moe_dropped_frac"))
    out = _main(name, "eval", *extra)
    assert "evaluating checkpoint at step 2" in out
    ev = json.loads(out[-1])
    assert math.isfinite(ev["eval_loss"]) and "eval_aux_loss" not in ev
    rec = json.loads(_main(name, "benchmark")[-1])
    assert rec["metric"] == f"{name}_lm_throughput"
    assert rec["value"] == pytest.approx(4 * 64 * rec["steps_per_sec"],
                                         rel=1e-3)
    layers = 1 if name == "gpt2_moe" else 2
    # c = 20 slots, embed 64, 4 rows x 64 tokens: 5 products a layer.
    onehot = layers * 5 * 2 * 4 * 64 * 8 * 20 * 64
    assert rec["onehot_tflops_per_step"] == pytest.approx(onehot / 1e12)
    assert 0 < rec["onehot_share_of_counted_flops"] < 1


@pytest.mark.parametrize("name", ["gpt2_moe", "llama_moe"])
def test_config_is_the_jax_package_s(name):
    ours = load_config(CONFIGS[name])
    theirs = jax_config.load_config(f"configs/{name}.py")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
