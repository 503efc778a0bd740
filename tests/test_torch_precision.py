"""The port's ``bf16_full`` policy against the JAX package's: bf16 Adam
moments written with stochastic rounding, every update computed in fp32.

- ``ops.fused_adamw.stochastic_round`` bit for bit against JAX's, fed JAX's
  own bits (``jax.random.bits(key) & 0xFFFF``): representable values,
  values between two bf16 neighbours, negatives, subnormals, the values
  that round to inf, and the non-finite ones, which bypass the add; it
  lands on the two neighbours only, unbiased; a target other than bf16 is
  refused;
- ``train.LowPrecisionAdamW`` over 3 steps against JAX's
  ``low_precision_adamw`` with JAX's bits fed in, the leaves mapped by name
  (JAX flattens dicts in sorted-key order): moments bit-equal, params
  within 1e-6 relative; through ``make_optimizer`` with an active clip;
- 5 Trainer steps of the tiny GPT-2 under ``bf16_full`` against the JAX
  Trainer's, from the JAX init, with JAX's bits: at bf16 compute the
  losses within 2e-4 relative and the update within 10% in norm; at fp32
  compute (the optimizer alone low-precision) losses within 1e-5, params
  within 5e-5 (each test states why);
- ZeRO-1: the shard update over 2 and 4 slices equals the unsharded update
  bit for bit (each leaf's bits sliced as the unsharded update draws
  them); dp=2 over two gloo ranks against one process, and its
  checkpoint restored into one process;
- checkpoints: bf16 moments round-trip bit for bit, and across policies
  (bf16_full saved, fp32 AdamW restored, and back);
- the optimizer state is half the bytes of fp32 AdamW's.
"""

import importlib
import os
import socket

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu import train as jax_train
from distributeddeeplearning_tpu.mesh import single_device_mesh
from distributeddeeplearning_tpu_torch import cli, data, train
from distributeddeeplearning_tpu_torch.checkpoint import CheckpointManager
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import (
    Mesh,
    build_mesh,
    init_distributed,
)
from distributeddeeplearning_tpu_torch.ops.fused_adamw import stochastic_round
from distributeddeeplearning_tpu_torch.parallel.zero import (
    ZeroLayout,
    ZeroState,
)
from distributeddeeplearning_tpu_torch.weights import from_jax_params

# The JAX package's ops re-export its functions under the module names.
jax_fa = importlib.import_module("distributeddeeplearning_tpu.ops.fused_adamw")

torch.set_num_threads(2)

SEED = 0x5F3759
CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
# helpers.train_tiny_gpt2's run on gpt2_owt's schema, under bf16_full.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=bfloat16",
    "model.kwargs.chunked_head=False", "model.kwargs.attn_impl=xla",
    "data.vocab_size=256", "data.seq_len=32", "data.batch_size=16",
    "data.n_distinct=4", "optim.name=adamw", "optim.lr=1e-3",
    "optim.b2=0.999", "optim.weight_decay=0.0", "optim.schedule=constant",
    "optim.warmup_steps=0", "optim.grad_clip=0.0",
    "train.precision.policy=bf16_full", "train.steps=5",
]


def _jax_bits(key, shape):
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)
                      & jnp.uint32(0xFFFF)).astype(np.int32)


def _values():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(500).astype(np.float32),
        (rng.standard_normal(200) * 1e-30).astype(np.float32),  # tiny
        np.float32(1e-40) * np.arange(1, 9, dtype=np.float32),  # subnormal
        np.array([1.0, -2.0, 0.0, -0.0, 1.0 + 1.0 / 512.0, 3.3895e38,
                  -3.3895e38, np.nan, np.inf, -np.inf], np.float32),
        # NaNs whose payload a carry would walk out of NaN space: the top
        # pattern wraps to -0.0 without the bypass.
        np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7F80FFFF],
                 np.uint32).view(np.float32),
    ])
    return x


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_stochastic_round_matches_jax_bit_for_bit(seed):
    x = _values()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_fa.stochastic_round(jnp.asarray(x), key))
    got = stochastic_round(torch.from_numpy(x),
                           torch.from_numpy(_jax_bits(key, x.shape)))
    assert got.dtype == torch.bfloat16
    # A NaN's sign and payload carry nothing (XLA and torch pick their
    # own): NaN where the reference has NaN, every other pattern equal.
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(got.float().isnan().numpy(), nan)
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[~nan],
                                  want.view(np.int16)[~nan])


def test_stochastic_round_neighbours_unbiased_and_exact():
    x = torch.full((8192,), 1.0 + 1.0 / 512.0)
    bits = torch.randint(0, 1 << 16, x.shape,
                         generator=torch.Generator().manual_seed(0))
    vals = stochastic_round(x, bits).float()
    lo, hi = 1.0, 1.0 + 1.0 / 128.0
    assert set(vals.unique().tolist()) == {lo, hi}
    assert abs(vals.mean().item() - x[0].item()) < 0.1 * (hi - lo)
    exact = torch.tensor([1.0, -0.5, 2.0 ** -10, 3.0]).to(torch.bfloat16)
    out = stochastic_round(exact.float(), torch.full((4,), 0xFFFF))
    assert torch.equal(out, exact)


def test_stochastic_round_refuses_a_non_bf16_target():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        stochastic_round(torch.ones(4), torch.zeros(4), dtype=torch.float16)


# ---------------------------------------------------------------------------
# low_precision_adamw against JAX's
# ---------------------------------------------------------------------------


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"norm": {"scale": leaf(8)},
            "dense": {"kernel": leaf(8, 16), "bias": leaf(16)},
            "embed": {"embedding": leaf(32, 8)}}


def _flat(tree):
    return {k: v.clone() for k, v in from_jax_params(tree).items()}


def jax_bits_source(names, shapes):
    """The port's bits callback answering with the reference's bits:
    ``names`` are the port's leaves in its params order; the reference
    numbers leaves in sorted-key order (``sorted`` of the dotted names is
    the order jax flattens nested dicts in) and keys the stream
    ``fold_in(fold_in(PRNGKey(SEED), count), 2 * i + moment)``."""
    jax_index = {n: i for i, n in enumerate(sorted(names))}

    def bits(count, leaf, numel, device):
        name = names[leaf // 2]
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), count)
        key = jax.random.fold_in(key, 2 * jax_index[name] + leaf % 2)
        b = _jax_bits(key, tuple(shapes[name]))
        assert b.size == numel
        return torch.from_numpy(b.reshape(-1)).to(device)

    return bits


def _port_in_jax_order_check():
    # Sorting dotted names gives jax's flatten order for these trees.
    leaves = jax.tree_util.tree_flatten_with_path(_tree(0))[0]
    names = [".".join(p.key for p in path) for path, _ in leaves]
    assert names == sorted(names)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_low_precision_adamw_matches_jax_for_three_steps(wd):
    _port_in_jax_order_check()
    sched_j = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    sched_t = train.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    jtx = jax_train.low_precision_adamw(
        sched_j, weight_decay=wd,
        mask=lambda p: jax.tree.map(jax_fa.decay_leaf, p))
    jp = _tree(1)
    jstate = jtx.init(jp)
    # The port's params in another order than jax's sorted one.
    tp = _flat(jp)
    tp = {k: tp[k] for k in ("norm.scale", "dense.kernel", "embed.embedding",
                             "dense.bias")}
    names = list(tp)
    ttx = train.LowPrecisionAdamW(
        sched_t, weight_decay=wd,
        bits=jax_bits_source(names, {k: v.shape for k, v in tp.items()}))
    tstate = ttx.init(tp)
    for step in range(3):
        g = _tree(10 + step, scale=1e-3)
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.update(_flat(g), tstate, tp)
    assert tstate.count == int(jstate.count) == 3
    for tree, got in (("mu", tstate.mu), ("nu", tstate.nu)):
        want = from_jax_params(jax.tree.map(np.asarray, getattr(jstate, tree)))
        for k in names:
            assert got[k].dtype == torch.bfloat16
            assert torch.equal(got[k].view(torch.int16),
                               want[k].view(torch.int16)), (tree, k)
    for k, v in from_jax_params(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_make_optimizer_bf16_full_with_an_active_clip():
    """``make_optimizer('adamw', precision='bf16_full', grad_clip=...)``:
    the reference chains its clip before the low-precision AdamW; the
    gradients here are far above the clip. The global norm is summed in
    another order, so a moment may land one bf16 ulp apart where its
    stochastic rounding sits on the boundary."""
    jtx = jax_train.make_optimizer("adamw", 1e-2, weight_decay=0.1,
                                   grad_clip=0.5, precision="bf16_full")
    ttx = train.make_optimizer("adamw", 1e-2, weight_decay=0.1,
                               grad_clip=0.5, precision="bf16_full")
    assert isinstance(ttx, train.LowPrecisionAdamW)
    jp = _tree(2)
    tp = _flat(jp)
    ttx.bits = jax_bits_source(list(tp), {k: v.shape for k, v in tp.items()})
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = _tree(20 + step)
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.update(_flat(g), tstate, tp)
    jlp = jstate[1]
    for tree in ("mu", "nu"):
        want = from_jax_params(jax.tree.map(np.asarray, getattr(jlp, tree)))
        for k, v in getattr(tstate, tree).items():
            np.testing.assert_allclose(v.float().numpy(),
                                       want[k].float().numpy(),
                                       rtol=2 ** -7, atol=0, err_msg=k)
    for k, v in from_jax_params(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(tp[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_default_bits_replay_per_key():
    a = train.rounding_bits(3, 5, 100, "cpu")
    assert torch.equal(a, train.rounding_bits(3, 5, 100, "cpu"))
    assert not torch.equal(a, train.rounding_bits(4, 5, 100, "cpu"))
    assert not torch.equal(a, train.rounding_bits(3, 6, 100, "cpu"))
    assert a.dtype == torch.int32 and 0 <= int(a.min()) and int(a.max()) < 65536


def test_round_to_nearest_when_stochastic_rounding_is_off():
    tp = _flat(_tree(3))
    tx = train.LowPrecisionAdamW(1e-2, stochastic_rounding=False)
    st = tx.init(tp)
    g = _flat(_tree(4))
    st = tx.update(g, st, tp)
    for k, v in g.items():
        want = (v * np.float32(0.1)).to(torch.bfloat16)
        assert torch.equal(st.mu[k], want), k


# ---------------------------------------------------------------------------
# Trainer under bf16_full against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX init's weights and JAX's 5 bf16_full steps from them."""
    from helpers import train_tiny_gpt2

    mesh = single_device_mesh()
    _, init = train_tiny_gpt2(mesh, n_steps=0)
    losses, state = train_tiny_gpt2(mesh, n_steps=5, dtype=jnp.bfloat16,
                                    precision="bf16_full")
    host = jax.tree.map(np.asarray, nn.meta.unbox(state.params))
    return (from_jax_params(jax.tree.map(np.asarray,
                                         nn.meta.unbox(init.params))),
            losses, from_jax_params(host), state.opt_state)


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


# fp32 compute, the bf16_full optimizer set by hand: what is left of the
# policy once the bf16 compute's noise is taken out.
FP32 = ["train.precision.policy=fp32", "model.kwargs.dtype=float32"]


def _fit(cfg, mesh, weights, jax_bits=False, steps=5, lp_adamw=False):
    """build_all + fit from ``weights``; ``jax_bits``: the optimizer draws
    the reference's rounding bits; ``lp_adamw``: the trainer's optimizer
    is ``LowPrecisionAdamW`` at the config's lr whatever the policy."""
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    if lp_adamw:
        trainer.tx = train.LowPrecisionAdamW(cfg.optim.lr)
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(weights, strict=True)
    if jax_bits:
        trainer.tx.bits = jax_bits_source(
            list(state.params), {k: p.shape for k, p in state.params.items()})
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=steps,
                            log_every=1, log_fn=lambda m: None)
    return trainer, state, [r["loss"] for r in hist]


def _update_rel_diff(got, want, init):
    """|| (got - init) - (want - init) || / || want - init || over the
    params, the key biases left out: a key bias shifts every score of a row
    by the same q.b, which the softmax cancels, so its gradient is zero up
    to rounding in both packages alike."""
    keys = [k for k in want if not k.endswith("key.bias")]
    num = sum(float((got[k] - want[k]).pow(2).sum()) for k in keys)
    den = sum(float((want[k] - init[k]).pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_trainer_matches_jax_for_five_steps(jax_runs):
    """bf16_full as shipped (bf16 compute): the losses within 2e-4
    relative (measured 5e-5), the 5 steps' update within 10% of JAX's in
    norm (measured 4%): Adam's first steps move an element by about lr
    whatever its gradient's size, so an element whose bf16 gradient is at
    rounding level moves either way in either package."""
    init, j_losses, j_params, _ = jax_runs
    trainer, state, losses = _fit(_cfg(), None, init, jax_bits=True)
    assert isinstance(trainer.tx, train.LowPrecisionAdamW)
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    assert j_losses[-1] < j_losses[0]
    np.testing.assert_allclose(losses, j_losses, rtol=2e-4)
    got = {k: p.detach() for k, p in state.params.items()}
    assert _update_rel_diff(got, j_params, init) < 0.1
    assert state.opt_state.count == 5


def test_trainer_fp32_compute_with_bf16_moments_matches_jax(jax_runs):
    """The low-precision AdamW in the JAX Trainer and the port's at fp32
    compute, 5 steps from the JAX init with JAX's bits: losses within 1e-5
    relative, params within 5e-5 (key biases at noise level in both), the
    moments equal but for under 2% of elements, which a last-bit difference
    in the fp32 gradient moves across a stochastic-rounding boundary: those
    within one bf16 ulp, or within 1% of the leaf's largest moment where a
    first moment near zero moves by more than its own size."""
    from distributeddeeplearning_tpu import data as jax_data
    from distributeddeeplearning_tpu import models as jax_models

    init = jax_runs[0]
    mesh = single_device_mesh()
    jm = jax_models.get_model("gpt2", size="tiny", vocab_size=256,
                              max_len=64, dropout_rate=0.0)
    ds = jax_data.SyntheticTokens(batch_size=16, seq_len=32, vocab_size=256,
                                  seed=0, n_distinct=4)
    jt = jax_train.Trainer(
        jm, jax_train.make_optimizer("adamw", 1e-3, precision="bf16_full"),
        jax_train.get_task("lm"), mesh, donate=False)
    js, j_losses = jt.init(0, ds.batch(0)), []
    for i, b in enumerate(jax_data.sharded_batches(ds, mesh)):
        if i == 5:
            break
        js, m = jt.train_step(js, b)
        j_losses.append(float(m["loss"]))
    _, state, losses = _fit(_cfg(*FP32), None, init, jax_bits=True,
                            lp_adamw=True)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for k, v in from_jax_params(jax.tree.map(
            np.asarray, nn.meta.unbox(js.params))).items():
        got = state.params[k].detach()
        if k.endswith("key.bias"):
            assert got.abs().max() < 1e-2 and v.abs().max() < 1e-2
            continue
        torch.testing.assert_close(got, v, rtol=0, atol=5e-5, msg=k)
    for tree in ("mu", "nu"):
        want = from_jax_params(jax.tree.map(np.asarray,
                                            getattr(js.opt_state, tree)))
        n = diff = 0
        for k, v in want.items():
            if k.endswith("key.bias"):
                continue
            got = getattr(state.opt_state, tree)[k]
            assert got.dtype == v.dtype == torch.bfloat16
            torch.testing.assert_close(
                got.float(), v.float(), rtol=2 ** -7,
                atol=1e-2 * float(v.float().abs().max()), msg=k)
            n, diff = n + v.numel(), diff + int((got != v).sum())
        assert diff < 0.02 * n, (tree, diff, n)


def test_optimizer_state_is_half_of_fp32_adamw(jax_runs):
    init = jax_runs[0]
    full = cli.build_all(_cfg(), "cpu")[1].init(0)
    plain = cli.build_all(_cfg("train.precision.policy=bf16",
                               "optim.name=adamw"), "cpu")[1].init(0)
    n = sum(p.numel() for p in init.values())
    assert train.opt_state_bytes(full.opt_state) == 2 * 2 * n
    assert train.opt_state_bytes(plain.opt_state) == 2 * 4 * n


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------


def _tiny_params(seed):
    from distributeddeeplearning_tpu_torch import models

    m = models.get_model("gpt2", size="tiny", vocab_size=67, max_len=16)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(p.shape)
                                .astype(np.float32))
            for k, p in m.named_parameters()}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_update_equals_unsharded_update(n):
    params = _tiny_params(1)
    grads = [{k: v * 1e-2 for k, v in _tiny_params(10 + i).items()}
             for i in range(3)]
    tx = train.LowPrecisionAdamW(1e-3, b2=0.95, weight_decay=0.1)
    full = {k: v.clone() for k, v in params.items()}
    state = tx.init(full)
    layouts = [ZeroLayout(params, Mesh({"dp": n}, r)) for r in range(n)]
    p_shards = [la.shard(params) for la in layouts]
    states = [ZeroState(0, *({g: torch.zeros_like(s, dtype=torch.bfloat16)
                              for g, s in ps.items()} for _ in "mn"), la)
              for la, ps in zip(layouts, p_shards)]
    for g_tree in grads:
        state = tx.update(g_tree, state, full)
        states = [tx.update_shard(la.shard(g_tree), st, ps, None)
                  for la, st, ps in zip(layouts, states, p_shards)]
    got = layouts[0].views({g: torch.cat([ps[g] for ps in p_shards])
                            for g in layouts[0].names})
    for tree in ("mu", "nu"):
        whole = layouts[0].views({
            g: torch.cat([getattr(st, tree)[g] for st in states])
            for g in layouts[0].names})
        for k in params:
            assert torch.equal(whole[k], getattr(state, tree)[k]), (tree, k)
    for k in params:
        assert torch.equal(got[k], full[k]), k
    assert all(st.count == 3 for st in states) and state.count == 3


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, weights_path, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert init_distributed("cpu")
    cfg = _cfg(*FP32, "mesh.dp=2", "train.zero1=True", "train.steps=3",
               f"train.checkpoint_dir={out_dir}/ckpt", "train.save_every=3")
    mesh = build_mesh(cfg.mesh)
    model, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    trainer.tx = train.LowPrecisionAdamW(cfg.optim.lr)
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(torch.load(weights_path), strict=True)
    with CheckpointManager(cfg.train.checkpoint_dir) as ckpt:
        batches = data.prefetch(
            data.sharded_batches(dataset.iter_from(0), mesh), "cpu")
        state, hist = train.fit(trainer, state, batches, steps=3,
                                log_every=1, log_fn=lambda m: None,
                                ckpt=ckpt, save_every=3)
        ckpt.wait()
    opt = state.opt_state
    torch.save({"losses": [r["loss"] for r in hist],
                "params": {k: p.detach().clone()
                           for k, p in state.params.items()},
                "sharded": isinstance(opt, ZeroState),
                "moment_bytes": train.opt_state_bytes(opt)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def test_zero1_dp2_over_gloo_matches_one_process(jax_runs, tmp_path):
    """Two gloo ranks, ZeRO-1 over dp=2 with the bf16 moments of
    ``LowPrecisionAdamW`` (fp32 compute, so the bf16 compute's noise stays
    out), against one process on the same global batches: the gradient is
    a mean of the two halves' here, of the whole batch there, so the
    losses agree within 1e-5 relative and the params within 5e-5; each
    rank holds half the bf16 moments; the dp=2 checkpoint (moments
    gathered to rank 0) restores into one process bit for bit."""
    init = jax_runs[0]
    path = tmp_path / "weights.pt"
    torch.save(init, path)
    torch.multiprocessing.spawn(_worker, args=(2, _free_port(), str(path),
                                               str(tmp_path)),
                                nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    _, single, losses = _fit(_cfg(*FP32, "train.steps=3"), None, init,
                             steps=3, lp_adamw=True)
    n = sum(p.numel() for p in init.values())
    for r in ranks:
        assert r["sharded"]
        assert 2 * n <= r["moment_bytes"] <= 2 * n + 64
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, p in single.params.items():
            torch.testing.assert_close(r["params"][k], p.detach(), rtol=0,
                                       atol=5e-5, msg=k)
    for k in init:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    # The dp=2 checkpoint restores into one process, bf16 moments intact.
    _, trainer, _ = cli.build_all(_cfg(*FP32), "cpu")
    trainer.tx = train.LowPrecisionAdamW(1e-3)
    with CheckpointManager(str(tmp_path / "ckpt")) as ckpt:
        restored, _ = ckpt.restore(trainer.init(1))
        host = ckpt._load(3)[0]
    assert restored.step == 3 and restored.opt_state.count == 3
    for k, m in restored.opt_state.mu.items():
        assert m.dtype == torch.bfloat16 and host["mu"][k].dtype == m.dtype
        assert torch.equal(m, host["mu"][k]), k
    for k, p in restored.params.items():
        assert torch.equal(p.detach(), ranks[0]["params"][k]), k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trips_across_policies(jax_runs, tmp_path):
    init = jax_runs[0]
    trainer, state, _ = _fit(_cfg("train.steps=2"), None, init, steps=2)
    with CheckpointManager(str(tmp_path / "full")) as ckpt:
        assert ckpt.save(2, state, {"next_index": 2})
    # bf16_full -> bf16_full: moments bit for bit.
    _, tr2, _ = cli.build_all(_cfg(), "cpu")
    with CheckpointManager(str(tmp_path / "full")) as ckpt:
        same, data_state = ckpt.restore(tr2.init(9))
    assert same.step == 2 and data_state["next_index"] == 2
    for tree in ("mu", "nu"):
        for k, m in getattr(state.opt_state, tree).items():
            got = getattr(same.opt_state, tree)[k]
            assert got.dtype == torch.bfloat16 and torch.equal(got, m)
    # bf16_full -> fp32 AdamW (bf16 compute kept): the moments widen
    # exactly, the masters are bit for bit, and it keeps training.
    _, tr3, ds3 = cli.build_all(
        _cfg("train.precision.policy=bf16"), "cpu")
    with CheckpointManager(str(tmp_path / "full")) as ckpt:
        wide, _ = ckpt.restore(tr3.init(9))
    for k, m in state.opt_state.mu.items():
        assert wide.opt_state.mu[k].dtype == torch.float32
        assert torch.equal(wide.opt_state.mu[k], m.float())
    for k, p in state.params.items():
        assert torch.equal(wide.params[k], p)
    wide, m = tr3.train_step(wide, data.to_device(ds3.batch(2), "cpu"))
    assert np.isfinite(float(m["loss"]))
    # ... and back: fp32 moments saved, bf16_full restored (rounded to
    # nearest once, as a cast).
    with CheckpointManager(str(tmp_path / "wide")) as ckpt:
        assert ckpt.save(3, wide, {"next_index": 3})
    _, tr4, _ = cli.build_all(_cfg(), "cpu")
    with CheckpointManager(str(tmp_path / "wide")) as ckpt:
        narrow, _ = ckpt.restore(tr4.init(9))
    for k, m in wide.opt_state.nu.items():
        assert torch.equal(narrow.opt_state.nu[k], m.to(torch.bfloat16))
    assert narrow.step == 3 and narrow.opt_state.count == 3
