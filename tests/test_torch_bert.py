"""The port's BERT masked LM against the JAX package's ``models/bert.py``,
``mlm_task`` and ``SyntheticMLM``.

A small BERT at head_dim 64 (embed 128, 2 heads, 2 layers, vocab 256) over
160-token rows with ``pad_min_len=40``: on the flash route the sequence is
padded to 256 (the static limit, 160) and each row's ``attention_mask``
becomes its key limit (``vl``), the two mask paths of BERT's padded batches
on the card. On the CPU the port's flash wrappers run their plain versions,
the JAX flash kernel runs in Pallas interpret mode.

- ``SyntheticMLM`` draws the reference's batches bit for bit;
- the JAX init's tree, every leaf redrawn from a seeded numpy generator,
  carried across by ``weights.from_jax_params``: fp32 MLM logits within
  1e-5 on the xla and flash cores, and the chunked head's MLM loss within
  1e-5;
- a mask that is no contiguous prefix poisons its row to NaN on the flash
  route, as in JAX;
- ``configs/bert_mlm.py`` cut to that size (fp32, flash, chunked head,
  the fused AdamW, ``grad_accum=2``) trains 5 steps from the JAX Trainer's
  init, in one process and over dp=2 (two gloo processes), against the JAX
  Trainer at dp=2: losses within 1e-4 relative, params within 1e-5. The
  loss divides by the masked count of the whole microbatch, which differs
  from rank to rank.
"""

import importlib
import os
import socket

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
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    opt_state_from_jax,
)

from helpers import mesh_of

jax_data = importlib.import_module("distributeddeeplearning_tpu.data")
jax_models = importlib.import_module("distributeddeeplearning_tpu.models")
jax_train = importlib.import_module("distributeddeeplearning_tpu.train")

torch.set_num_threads(4)

CONFIG = "distributeddeeplearning_tpu_torch/configs/bert_mlm.py"
SEQ, PAD_MIN, VOCAB = 160, 40, 256
SMALL = dict(size="tiny", num_layers=2, num_heads=2, embed_dim=128,
             vocab_size=VOCAB, max_len=SEQ)
STEPS = 5
TRAIN = [
    "model.kwargs.size=tiny", "model.kwargs.num_layers=2",
    "model.kwargs.num_heads=2", "model.kwargs.embed_dim=128",
    f"model.kwargs.vocab_size={VOCAB}", f"model.kwargs.max_len={SEQ}",
    "model.kwargs.dtype=float32", f"data.vocab_size={VOCAB}",
    f"data.seq_len={SEQ}", f"data.pad_min_len={PAD_MIN}",
    "data.batch_size=8", "data.n_distinct=2", "optim.warmup_steps=2",
    "train.grad_accum=2", "train.head_chunk=64", f"train.steps={STEPS}",
]


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


@pytest.mark.parametrize("seed,n_distinct,index,pad_min_len", [
    (0, 8, 0, 0), (0, 8, 11, 0), (3, 0, 5, 40), (1, 2, 1, 160)])
def test_synthetic_mlm_bit_exact(seed, n_distinct, index, pad_min_len):
    kw = dict(batch_size=5, seq_len=SEQ, vocab_size=30522, seed=seed,
              n_distinct=n_distinct, pad_min_len=pad_min_len)
    want = jax_data.SyntheticMLM(**kw).batch(index)
    got = data.SyntheticMLM(**kw).batch(index)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="pad_min_len"):
        data.SyntheticMLM(**{**kw, "pad_min_len": SEQ + 1}).batch(0)


@pytest.fixture(scope="module")
def weights_and_batch():
    jm = jax_models.get_model("bert", **SMALL)
    params = _host(jm.init(jax.random.PRNGKey(0),
                           np.zeros((1, SEQ), np.int32))["params"])
    rng = np.random.default_rng(0)

    def redraw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        return (1.0 + 0.1 * noise) if path[-1].key == "scale" else (
            0.05 * noise)

    params = jax.tree_util.tree_map_with_path(redraw, params)
    batch = jax_data.SyntheticMLM(batch_size=3, seq_len=SEQ,
                                  vocab_size=VOCAB,
                                  pad_min_len=PAD_MIN).batch(1)
    assert batch["attention_mask"].sum(1).min() < SEQ  # some rows padded
    return params, batch


def _port(params, **kw):
    m = models.get_model("bert", **SMALL, **kw)
    m.load_state_dict(from_jax_params(params), strict=True)
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_fp32_mlm_logits_match_jax(weights_and_batch, attn_impl):
    params, b = weights_and_batch
    jm = jax_models.get_model("bert", **SMALL, attn_impl=attn_impl)
    want = np.asarray(jm.apply({"params": params}, b["input_tokens"],
                               b["attention_mask"]))
    got = _port(params, attn_impl=attn_impl)(_t(b["input_tokens"]),
                                             _t(b["attention_mask"]))
    assert got.dtype == torch.float32 and got.shape == (3, SEQ, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_chunked_head_mlm_loss_matches_jax(weights_and_batch, attn_impl):
    params, b = weights_and_batch
    jm = jax_models.get_model("bert", **SMALL, attn_impl=attn_impl,
                              chunked_head=True)
    jtask = jax_train.get_task("mlm", head_chunk=64)
    out = jm.apply({"params": params}, *jtask.input_fn(b))
    want, jmet = jtask.loss_fn(out, b)
    task = train.get_task("mlm", head_chunk=64)
    tb = {k: _t(v) for k, v in b.items()}
    got, met = task.loss_fn(_port(params, attn_impl=attn_impl,
                                  chunked_head=True)(*task.input_fn(tb)), tb)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(met["masked_fraction"].item(),
                               float(jmet["masked_fraction"]), rtol=1e-7)


def test_non_prefix_mask_poisons_its_row_on_the_flash_route(
        weights_and_batch):
    params, b = weights_and_batch
    mask = b["attention_mask"].copy()
    mask[0, 5] = 0  # a hole: no contiguous prefix
    jm = jax_models.get_model("bert", **SMALL, attn_impl="flash")
    want = np.asarray(jm.apply({"params": params}, b["input_tokens"], mask))
    got = _port(params, attn_impl="flash")(_t(b["input_tokens"]),
                                           _t(mask)).detach().numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    assert np.isfinite(got[1:]).all()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5, atol=1e-5)


def test_seq_len_over_max_len_is_refused():
    m = models.get_model("bert", **SMALL)
    with pytest.raises(ValueError, match="exceeds max_len"):
        m(torch.zeros(1, SEQ + 1, dtype=torch.long))


# ---------------------------------------------------------------------------
# 5 steps at grad_accum=2: one process and dp=2 against JAX at dp=2
# ---------------------------------------------------------------------------


def _cfg(dp):
    return apply_overrides(load_config(CONFIG), TRAIN + [f"mesh.dp={dp}"])


@pytest.fixture(scope="module")
def jax_run():
    """(init state, losses, params) of the JAX Trainer at dp=2."""
    cfg = _cfg(2)
    o = cfg.optim
    tx = jax_train.make_optimizer(
        o.name, o.lr, b1=o.b1, b2=o.b2, weight_decay=o.weight_decay,
        warmup_steps=o.warmup_steps, schedule=o.schedule,
        total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    jm = jax_models.get_model("bert", **SMALL, attn_impl="flash",
                              chunked_head=True)
    trainer = jax_train.Trainer(
        jm, tx, jax_train.get_task("mlm", head_chunk=64), mesh_of(dp=2),
        grad_accum=2, donate=False)
    ds = jax_data.SyntheticMLM(**cfg.data.dataset_kwargs())
    state = trainer.init(0, ds.batch(0))
    init = _host(state)
    losses = []
    for batch in jax_data.sharded_batches(
            (ds.batch(i) for i in range(STEPS)), trainer.mesh):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
    return init, losses, from_jax_params(_host(state.params))


def _fit(cfg, mesh, init):
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    assert trainer.grad_accum == 2
    state = trainer.init(cfg.train.seed)
    trainer.model.load_state_dict(from_jax_params(init.params), strict=True)
    state.opt_state = opt_state_from_jax(init.opt_state, state.opt_state)
    batches = data.prefetch(data.sharded_batches(
        dataset.iter_from(0), mesh, cfg.train.grad_accum), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=STEPS,
                            log_every=1, log_fn=lambda m: None)
    return ([r["loss"] for r in hist],
            {k: p.detach().clone() for k, p in state.params.items()},
            [r["masked_fraction"] for r in hist])


def _worker(rank, port, init_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    assert init_distributed("cpu")
    cfg = _cfg(2)
    out = _fit(cfg, build_mesh(cfg.mesh),
               torch.load(init_path, weights_only=False))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """{"dp1": [(losses, params, masked fractions)], "dp2": [rank 0's,
    rank 1's]}."""
    tmp = tmp_path_factory.mktemp("bert")
    torch.save(jax_run[0], tmp / "init.pt")
    torch.multiprocessing.spawn(_worker, args=(_free_port(),
                                               str(tmp / "init.pt"),
                                               str(tmp)),
                                nprocs=2, join=True)
    return {"dp1": [_fit(_cfg(1), None, jax_run[0])],
            "dp2": [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                    for r in range(2)]}


@pytest.mark.parametrize("run", ["dp1", "dp2"])
def test_trainer_matches_jax_for_five_steps(run, jax_run, port_runs):
    _, j_losses, j_params = jax_run
    assert j_losses[-1] < j_losses[0]
    for losses, params, fractions in port_runs[run]:
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
        assert all(0.05 < f < 0.15 for f in fractions)  # pads hold none
        for k, v in j_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


def test_dp2_ranks_agree_bit_for_bit(port_runs):
    (la, pa, _), (lb, pb, _) = port_runs["dp2"]
    assert la == lb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
