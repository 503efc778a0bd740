"""The port's training slice against the JAX package's.

- ``SyntheticTokens`` draws the reference's batches bit for bit;
- ``chunked_xent`` (``torch.utils.checkpoint`` per chunk) gives the
  reference's per-token loss and gradients within 1e-5;
- a tiny GPT-2 (2 layers, width 64, vocab 256, seq 64, batch 4) at fp32,
  from the JAX init's weights (``from_jax_params``) and its bridged
  optimizer state, trains 5 steps in the JAX ``Trainer`` (one CPU device,
  flash attention and the fused AdamW kernel in Pallas interpret mode,
  warmup-cosine schedule, clip 1.0) and in the port's ``cli``-built trainer
  on ``--device cpu``: losses agree within 1e-4, params within 1e-5;
- ``cli train`` prints the reference's record keys, and the precision
  policies and tasks keep the reference's fences.
"""

import contextlib
import io
import json
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import data as jax_data
from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu import precision as jax_precision
from distributeddeeplearning_tpu.ops.chunked_xent import (
    chunked_xent as jax_chunked_xent,
)
from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
from distributeddeeplearning_tpu.train import get_task as jax_get_task
from distributeddeeplearning_tpu.train import make_optimizer as jax_make_opt
from distributeddeeplearning_tpu_torch import cli, data, metrics, models
from distributeddeeplearning_tpu_torch import precision, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.ops.chunked_xent import chunked_xent
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    opt_state_from_jax,
)

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
# gpt2_owt at the tiny size, fp32, a schedule short enough to move.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=64", "data.batch_size=4",
    "optim.lr=1e-2", "optim.warmup_steps=2", "train.steps=5",
    "train.head_chunk=16",
]


@pytest.mark.parametrize("seed,n_distinct,index",
                         [(0, 8, 0), (0, 8, 11), (3, 0, 5)])
def test_synthetic_tokens_bit_exact(seed, n_distinct, index):
    kw = dict(batch_size=3, seq_len=17, vocab_size=50257, seed=seed,
              n_distinct=n_distinct)
    want = jax_data.SyntheticTokens(**kw).batch(index)
    got = data.SyntheticTokens(**kw).batch(index)
    assert got["tokens"].dtype == want["tokens"].dtype
    assert np.array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("with_bias", [False, True])
def test_chunked_xent_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 13, 16)).astype(np.float32)
    e = (rng.standard_normal((40, 16)) * 0.3).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32) if with_bias else None
    t = rng.integers(0, 40, (2, 13)).astype(np.int32)
    w = rng.standard_normal((2, 13)).astype(np.float32)

    def jloss(h, e, b):
        out = {"hidden": h, "emb": e, **({"bias": b} if with_bias else {})}
        per_tok = jax_chunked_xent(out, t, seq_chunk=5)
        return jnp.sum(per_tok * w), per_tok

    argn = (0, 1, 2) if with_bias else (0, 1)
    args = (h, e, b) if with_bias else (h, e, None)
    (_, per_j), g_j = jax.value_and_grad(jloss, argnums=argn,
                                         has_aux=True)(*args)
    th, te = (torch.from_numpy(x.copy()).requires_grad_() for x in (h, e))
    out = {"hidden": th, "emb": te}
    leaves = [th, te]
    if with_bias:
        tb = torch.from_numpy(b.copy()).requires_grad_()
        out["bias"] = tb
        leaves.append(tb)
    per_tok = chunked_xent(out, torch.from_numpy(t), seq_chunk=5)
    g = torch.autograd.grad((per_tok * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(per_tok.detach().numpy(), per_j, rtol=1e-5,
                               atol=1e-5)
    for a, b_ in zip(g, g_j):
        np.testing.assert_allclose(a.numpy(), b_, rtol=1e-5, atol=1e-5)


def _port_trainer(overrides):
    cfg = apply_overrides(load_config(CONFIG), TINY + overrides)
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    return cfg, model, trainer, dataset


def test_trainer_matches_jax_for_five_steps(mesh1):
    cfg, model, trainer, dataset = _port_trainer([])
    assert model.attn_impl == "flash" and cfg.optim.name == "adamw_fused"
    jm = jax_models.get_model(
        "gpt2", size="tiny", vocab_size=256, max_len=64, attn_impl="flash",
        chunked_head=True)
    jtx = jax_make_opt(
        "adamw_fused", cfg.optim.lr, b1=cfg.optim.b1, b2=cfg.optim.b2,
        weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, schedule=cfg.optim.schedule,
        total_steps=cfg.train.steps, grad_clip=cfg.optim.grad_clip)
    jtrainer = JaxTrainer(jm, jtx, jax_get_task("lm", head_chunk=16), mesh1,
                          donate=False)
    jds = jax_data.SyntheticTokens(batch_size=4, seq_len=64, vocab_size=256)
    jstate = jtrainer.init(0, jds.batch(0))
    params = jax.tree.map(np.asarray, nn.meta.unbox(jstate.params))

    state = trainer.init(cfg.train.seed)
    model.load_state_dict(from_jax_params(params), strict=True)
    state.opt_state = opt_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state), state.opt_state)

    j_losses = []
    for batch in jax_data.sharded_batches(
            (jds.batch(i) for i in range(5)), mesh1):
        jstate, m = jtrainer.train_step(jstate, batch)
        j_losses.append(float(m["loss"]))
    state, hist = train.fit(trainer, state,
                            data.prefetch(dataset.iter_from(0), "cpu"),
                            steps=5, log_every=1, log_fn=lambda m: None)
    losses = [r["loss"] for r in hist]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert set(hist[0]) == set(metrics.TRAIN_KEYS)
    want = from_jax_params(jax.tree.map(np.asarray,
                                        nn.meta.unbox(jstate.params)))
    for k, v in want.items():
        got = state.params[k].detach().numpy()
        if k.endswith("attn.key.bias"):
            # A key bias shifts every score of a row by the same q.b: the
            # softmax cancels it, so its gradient is 0 up to rounding, and
            # Adam scales that rounding noise up to steps of ~lr * 1e-2 in
            # both packages alike. Both stay at noise level.
            assert np.abs(got).max() < 1e-3 and np.abs(v.numpy()).max() < 1e-3
            continue
        np.testing.assert_allclose(got, v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert state.opt_state.count == int(jstate.opt_state.count) == 5


def test_kernel_and_plain_routes_agree_on_cpu():
    """(flash, adamw_fused) and (xla, adamw): one function, two routes."""
    runs = {}
    for route in (["model.kwargs.attn_impl=flash", "optim.name=adamw_fused"],
                  ["model.kwargs.attn_impl=xla", "optim.name=adamw"]):
        cfg, _, trainer, dataset = _port_trainer(route)
        state = trainer.init(cfg.train.seed)
        _, hist = train.fit(trainer, state, iter(
            data.to_device(dataset.batch(i), "cpu") for i in range(3)),
            steps=3, log_every=1, log_fn=lambda m: None)
        runs[route[0]] = [r["loss"] for r in hist]
    a, b = runs.values()
    np.testing.assert_allclose(a, b, rtol=1e-4)


def test_bf16_policy_casts_a_compute_copy():
    """train.precision.policy=bf16: the model computes in bf16 from one
    cast of the fp32 masters, which stay fp32 and move."""
    cfg, model, trainer, dataset = _port_trainer([
        "train.precision.policy=bf16", "model.kwargs.dtype=bfloat16",
        "optim.warmup_steps=0"])
    assert model.dtype == torch.bfloat16
    state = trainer.init(cfg.train.seed)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, m = trainer.train_step(state, data.to_device(dataset.batch(0),
                                                        "cpu"))
    assert math.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert not torch.equal(before["wte.embedding"],
                           state.params["wte.embedding"])
    with pytest.raises(ValueError, match="conflicts with"):
        _port_trainer(["train.precision.policy=bf16"])


def test_cli_train_on_cpu_prints_the_reference_records():
    argv = ["train", "--config", CONFIG, "--device", "cpu", "--sync-steps"]
    for o in TINY + ["train.steps=3", "train.log_every=1",
                     "model.kwargs.dtype=bfloat16"]:
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    recs = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]
    train_recs = [r for r in recs if "event" not in r]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    assert all(set(r) == set(metrics.TRAIN_KEYS) for r in train_recs)
    assert all(math.isfinite(r["loss"]) for r in train_recs)
    end = recs[-1]
    assert end["event"] == "train_end" and len(end["step_s"]) == 3


def test_deferred_metrics_lag_one_interval():
    out = []
    d = metrics.DeferredMetrics(out.append)
    d.push(1, {"loss": torch.tensor(2.0)}, wall_s=0.1)
    assert out == []
    d.push(2, {"loss": torch.tensor(1.0)}, wall_s=0.2)
    assert out == [{"loss": 2.0, "step": 1, "wall_s": 0.1}]
    d.flush()
    assert out[-1] == {"loss": 1.0, "step": 2, "wall_s": 0.2}


def test_dropout_follows_the_step_generator():
    m = models.get_model("gpt2", size="tiny", vocab_size=64, max_len=16,
                         dropout_rate=0.2)
    m.init_weights(torch.Generator().manual_seed(0))
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                        .manual_seed(1))

    def run(step):
        g = torch.Generator().manual_seed(train.fold_in_step(0, step))
        return m(tok, train=True, generator=g)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(m(tok), m(tok, train=False))
    assert not torch.equal(m(tok), run(3))
    with pytest.raises(ValueError, match="dropout generator"):
        m(tok, train=True)


@pytest.mark.parametrize("policy", ["fp32", "bf16", "bf16_full", "fp8"])
@pytest.mark.parametrize("optim", ["adamw", "adamw_fused", "sgd"])
def test_precision_fences_follow_the_reference(policy, optim):
    """A pair the reference refuses, the port refuses with its message; a
    pair it accepts, the port accepts."""
    try:
        jax_precision.check_precision_composition(policy, optim_name=optim)
        j_err = None
    except ValueError as e:
        j_err = str(e)
    if j_err is not None:
        with pytest.raises(ValueError) as e:
            precision.check_precision_composition(policy, optim_name=optim)
        assert str(e.value).split(":")[0] == j_err.split(":")[0]
    else:
        p = precision.check_precision_composition(policy, optim_name=optim)
        assert p.name == policy
        assert p.mixed == (policy in ("bf16", "bf16_full"))
        assert p.moment_dtype == (torch.bfloat16 if policy == "bf16_full"
                                  else torch.float32)
    assert precision.POLICIES == jax_precision.POLICIES


@pytest.mark.parametrize("task", ["classification", "mlm"])
def test_unported_tasks_refused_by_name(task):
    """Every task of the reference is ported: ``classification`` with
    ResNet (``tests/test_torch_resnet.py`` holds it against JAX's), ``mlm``
    with BERT (``tests/test_torch_bert.py``); an unknown name is refused."""
    if task == "classification":
        assert train.get_task(task, label_smoothing=0.1).input_fn(
            {"image": 1}) == (1,)
    else:
        t = train.get_task(task, head_chunk=16)
        assert t.input_fn({"input_tokens": 1}) == (1,)
        assert t.input_fn({"input_tokens": 1, "attention_mask": 2}) == (1, 2)
    with pytest.raises(KeyError, match="unknown task"):
        train.get_task("nsp")
    with pytest.raises(TypeError, match="unknown task knob"):
        train.get_task("lm", head_chunks=3)
