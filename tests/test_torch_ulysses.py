"""Context parallelism on a rank's heads: Ulysses (``ulysses``,
``ulysses_flash``) over (tp, cp) and the ring cores under tp and fsdp,
against the JAX package.

Single process:
- ``comms.all_to_all_dim``'s forward and gradient against a gather and a
  slice of the whole tensor, on virtual ranks (threads, the lockstep
  transport of ``tests/torch_sharded.py``);
- ``check_ulysses_shapes`` against JAX's messages;
- the heads a rank holds after the reshard, at tp2 x cp4 (8 virtual ranks),
  against JAX's ``heads_attn -> ('tp', 'cp')`` constraint on its 8-device
  CPU mesh;
- a ring over one rank (``mesh.cp=1``) against the flash core's plain
  version, and the reference's errors (ViT's 197 tokens under cp, a mask
  on the ring or ``ulysses_flash``, heads that tp x cp does not divide).

One spawn of 4 gloo ranks, 5 steps of each job against JAX's Trainer on
one device (``tests/torch_sharded.py``'s setting: losses per step and the
final params, gathered whole, within rtol 2e-4 / atol 2e-5), as JAX's own
Ulysses tests hold against one device:
- GPT-2 on ``ulysses`` and ``ulysses_flash`` (the plain core here) at tp2 x
  cp2 and at dp2 x cp2 with ZeRO-1;
- GPT-2 on ``ring`` and ``ring_pallas`` at tp2 x cp2 with sequence
  parallelism and at fsdp2 x cp2;
- Llama at tp2 x cp2 on ``ulysses_flash`` (K and V repeated before the
  reshard);
- llama_moe at tp2 x cp2 on ``ring_pallas`` and gpt2_moe at ep2 x cp2 on
  ``ulysses``, 4 experts at capacity factor 0.5 (drops in every routed
  layer, the counts carried across the cp blocks);
- BERT at dp2 x cp2 on ``ulysses`` over padded rows (the mask gathered over
  cp, the masked-token count summed over it), 2 microbatches a step;
- the tp2 x cp2 ``ulysses_flash`` run saved and restored on one rank, bit
  for bit;
- then ``cli train``, ``cli eval`` and ``cli benchmark`` on the tiny
  gpt2_moe config with cp beside tp (SP) and ep, the benchmark's FLOPs a
  step equal to one process's.
"""

import contextlib
import importlib
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import torch_sharded as ts
from distributeddeeplearning_tpu_torch import cli, comms, models
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import Mesh
from distributeddeeplearning_tpu_torch.parallel import sp_ulysses

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dict(num_experts=4, capacity_factor=0.5)
TP_CP = dict(dp=1, tp=2, cp=2)
JOBS = {
    "gpt2_ulysses_tp2_cp2": ("gpt2", TP_CP, {"attn_impl": "ulysses"}),
    "gpt2_ulysses_flash_tp2_cp2": ("gpt2", TP_CP,
                                   {"attn_impl": "ulysses_flash"}),
    "gpt2_ulysses_dp2_cp2_zero1": ("gpt2", dict(dp=2, cp=2),
                                   {"attn_impl": "ulysses", "zero1": True}),
    "gpt2_ulysses_flash_dp2_cp2_zero1": (
        "gpt2", dict(dp=2, cp=2), {"attn_impl": "ulysses_flash",
                                   "zero1": True}),
    "gpt2_ring_sp_tp2_cp2": ("gpt2", TP_CP, {"attn_impl": "ring",
                                             "sequence_parallel": True}),
    "gpt2_ring_pallas_sp_tp2_cp2": ("gpt2", TP_CP,
                                    {"attn_impl": "ring_pallas",
                                     "sequence_parallel": True}),
    "gpt2_ring_fsdp2_cp2": ("gpt2", dict(dp=1, fsdp=2, cp=2),
                            {"attn_impl": "ring"}),
    "gpt2_ring_pallas_fsdp2_cp2": ("gpt2", dict(dp=1, fsdp=2, cp=2),
                                   {"attn_impl": "ring_pallas"}),
    "llama_ulysses_flash_tp2_cp2": ("llama", TP_CP,
                                    {"attn_impl": "ulysses_flash"}),
    "llama_moe_ring_pallas_tp2_cp2": ("llama_moe", TP_CP,
                                      {"attn_impl": "ring_pallas",
                                       "model_kw": MOE}),
    "gpt2_moe_ulysses_ep2_cp2": ("gpt2_moe", dict(dp=1, ep=2, cp=2),
                                 {"attn_impl": "ulysses", "model_kw": MOE}),
}
SAVED = "gpt2_ulysses_flash_tp2_cp2"
STEPS = ts.STEPS
BERT = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=61",
        "data.vocab_size=61", "model.kwargs.max_len=32", "data.seq_len=16",
        "data.batch_size=8", "data.pad_min_len=8", "train.head_chunk=8",
        "train.grad_accum=2", "optim.lr=1e-3", "model.kwargs.dtype=float32",
        "optim.schedule=constant", "optim.warmup_steps=0",
        "optim.weight_decay=0.1", "optim.grad_clip=0.05",
        f"train.steps={STEPS}", "data.n_distinct=2"]
BERT_MESH = ["mesh.dp=2", "mesh.cp=2", "model.kwargs.attn_impl=ulysses"]
# cli runs on the tiny gpt2_moe in the ranks (``cli.main`` as torchrun
# would run it, each on its own MASTER_PORT): train at tp2 x cp2 with SP
# and a save, eval of that save at ep2 x cp2 on the ring, and a benchmark
# at tp2 x cp2, whose FLOPs a step equal one process's.
MOE_CONFIG = f"{ROOT}/distributeddeeplearning_tpu_torch/configs/gpt2_moe.py"
MOE_TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=64",
    "model.kwargs.max_len=32", "model.kwargs.num_experts=4",
    "model.kwargs.dtype=float32", "data.vocab_size=64", "data.seq_len=16",
    "data.batch_size=8", "optim.warmup_steps=1", "train.log_every=1"]
CLI_RUNS = {
    "train": (["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
               "model.kwargs.attn_impl=ulysses_flash",
               "train.sequence_parallel=true", "train.steps=2",
               "train.save_every=2"], ["--sync-steps"]),
    "eval": (["mesh.dp=1", "mesh.ep=2", "mesh.cp=2",
              "model.kwargs.attn_impl=ring"], []),
    "benchmark": (["mesh.dp=1", "mesh.tp=2", "mesh.cp=2",
                   "model.kwargs.attn_impl=ulysses"],
                  ["--steps", "1", "--latency-steps", "0", "--probe", "0"]),
}


def _bert_cfg(overrides=()):
    return apply_overrides(load_config(
        f"{ROOT}/distributeddeeplearning_tpu_torch/configs/bert_mlm.py"),
        BERT + list(overrides))


def _bert_job(jax_init):
    from distributeddeeplearning_tpu_torch import data, train, weights
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    cfg = _bert_cfg(BERT_MESH)
    mesh = build_mesh(cfg.mesh)
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = weights.state_from_jax(jax_init, trainer.init(0))
    batches = data.sharded_batches(dataset.iter_from(0), mesh,
                                   cfg.train.grad_accum)
    state, hist = train.fit(trainer, state, data.prefetch(batches, "cpu"),
                            steps=STEPS, log_every=1, log_fn=lambda m: None)
    return {"losses": [r["loss"] for r in hist if "loss" in r],
            "masked": [r["masked_fraction"] for r in hist if "loss" in r],
            "params": {k: v.detach().clone()
                       for k, v in state.params.items()}}


def _cli_argv(cmd, overrides, extra, ck):
    argv = [cmd, "--config", MOE_CONFIG, "--device", "cpu", *extra]
    for o in MOE_TINY + overrides + [f"train.checkpoint_dir={ck}"]:
        argv += ["--override", o]
    return argv


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def _worker(rank, world, port, tmp, inits, ports):
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    inits = torch.load(inits, weights_only=False)
    out = {}
    for job, (name, axes, kw) in JOBS.items():
        mesh = build_mesh(MeshConfig(**axes))
        r = ts.port_run(name, mesh, inits[name], **kw)
        out[job] = {k: r[k] for k in ("losses", "metrics", "params",
                                      "fraction", "coords")}
        if job == SAVED:
            with CheckpointManager(os.path.join(tmp, "ckpt")) as mgr:
                mgr.save(STEPS, r["state"], {"next_index": STEPS})
    out["bert"] = _bert_job(inits["bert"])
    dist.destroy_process_group()
    for i, (cmd, (overrides, extra)) in enumerate(CLI_RUNS.items()):
        os.environ["MASTER_PORT"] = str(ports[i])
        out[f"cli_{cmd}"] = _cli(_cli_argv(cmd, overrides, extra,
                                           os.path.join(tmp, "ck_cli")))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


# ---------------------------------------------------------------------------
# JAX's Trainer on one device
# ---------------------------------------------------------------------------


def _host(tree):
    import flax.linen as nn
    import jax

    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


def _jax_bert():
    """(JAX's one-device BERT trainer, its init state, its dataset)."""
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu.mesh import single_device_mesh

    jmodels = importlib.import_module("distributeddeeplearning_tpu.models")
    jtrain = importlib.import_module("distributeddeeplearning_tpu.train")
    cfg = _bert_cfg()
    kw = {k: v for k, v in cfg.model.kwargs.items() if k != "dtype"}
    kw["attn_impl"] = "xla"
    o, t = cfg.optim, cfg.train
    tx = jtrain.make_optimizer("adamw", o.lr, b1=o.b1, b2=o.b2,
                               weight_decay=o.weight_decay,
                               grad_clip=o.grad_clip)
    trainer = jtrain.Trainer(
        jmodels.get_model("bert", **kw), tx,
        jtrain.get_task("mlm", head_chunk=t.head_chunk),
        single_device_mesh(), donate=False, grad_accum=t.grad_accum)
    ds = jdata.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return trainer, trainer.init(0, ds.batch(0)), ds


def _jax_bert_fit(trainer, state, ds):
    from distributeddeeplearning_tpu import data as jdata

    losses, masked = [], []
    for _, batch in zip(range(STEPS), jdata.sharded_batches(ds,
                                                            trainer.mesh)):
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        masked.append(float(m["masked_fraction"]))
    return {"losses": losses, "masked": masked,
            "params": _host(state.params)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ulysses")
    names = {"gpt2": {}, "llama": {}, "llama_moe": MOE, "gpt2_moe": MOE}
    inits = {n: ts.port_init(n, **kw) for n, kw in names.items()}
    bert = _jax_bert()
    torch.save({**inits, "bert": _host(bert[1])}, tmp / "inits.pt")

    def parent():
        refs = {n: ts.jax_run(n, inits[n], **kw) for n, kw in names.items()}
        refs["bert"] = _jax_bert_fit(*bert)
        bench = CLI_RUNS["benchmark"]
        refs["bench"] = _records(_cli(_cli_argv(
            "benchmark", ["mesh.dp=1", "model.kwargs.attn_impl=ulysses"],
            bench[1], tmp / "ck_one")))[-1]
        return refs

    ranks, refs = ts.spawn(_worker, 4, tmp, str(tmp / "inits.pt"),
                           ts.free_ports(len(CLI_RUNS)), parent=parent)
    return ranks, refs, inits, tmp


@pytest.mark.parametrize("job", list(JOBS))
def test_losses_and_params_match_jax(run, job):
    ranks, refs, _, _ = run
    name = JOBS[job][0]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], refs[name]["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
    ts.assert_params_close(ranks[0][job]["params"], refs[name]["params"])


@pytest.mark.parametrize("job", [j for j in JOBS if "moe" in j])
def test_routing_metrics_match_jax(run, job):
    """aux_loss and moe_dropped_frac with drops present: the routing's
    counts carried across the cp blocks of every row."""
    ranks, refs, _, _ = run
    want = refs[JOBS[job][0]]["metrics"]
    for r in ranks:
        for key in ("aux_loss", "moe_dropped_frac"):
            np.testing.assert_allclose(
                [m[key] for m in r[job]["metrics"]], [m[key] for m in want],
                rtol=ts.RTOL, atol=ts.ATOL, err_msg=key)
    assert all(m["moe_dropped_frac"] > 0.1 for m in want)


@pytest.mark.parametrize("job", list(JOBS))
def test_the_ranks_agree_and_the_cut_is_real(run, job):
    ranks, _, _, _ = run
    _, axes, _ = JOBS[job]
    assert all(r[job]["losses"] == ranks[0][job]["losses"] for r in ranks)
    for axis in ("tp", "fsdp", "ep"):
        if axes.get(axis, 1) > 1:
            assert all(r[job]["fraction"][axis] > 0.1 for r in ranks), axis
    assert {r[job]["coords"]["cp"] for r in ranks} == {0, 1}


def test_bert_on_ulysses_over_padded_rows_matches_jax(run):
    from distributeddeeplearning_tpu_torch import weights

    ranks, refs, _, _ = run
    want = refs["bert"]
    names = {k for k, _ in cli.build_model(_bert_cfg(), "cpu")
             .named_parameters()}
    flat = weights.to_torch_layout(weights.from_jax_params(want["params"]),
                                   names)
    for r in ranks:
        np.testing.assert_allclose(r["bert"]["losses"], want["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
        np.testing.assert_allclose(r["bert"]["masked"], want["masked"],
                                   rtol=1e-6)
        ts.assert_params_close(r["bert"]["params"], flat)


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_cli_train_and_eval_under_tp_and_ep_with_cp(run):
    """``cli train`` on configs/gpt2_moe.py at tp2 x cp2 with SP on
    ``ulysses_flash`` (4 gloo ranks, a save at step 2), then ``cli eval``
    of that save at ep2 x cp2 on the ring."""
    ranks, _, _, _ = run
    text = ranks[0]["cli_train"]
    assert "'tp': 2" in text and "'cp': 2" in text
    recs = [r for r in _records(text) if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(math.isfinite(r[k]) for k in ("loss", "aux_loss",
                                                  "moe_dropped_frac"))
    end = [r for r in _records(text) if r.get("event") == "train_end"][0]
    assert all(r["shards"]["sharded_fraction"]["tp"] > 0.5
               for r in end["ranks"])
    assert "evaluating checkpoint at step 2" in ranks[0]["cli_eval"]
    assert math.isfinite(_records(ranks[0]["cli_eval"])[-1]["eval_loss"])


def test_benchmark_counts_a_cp_ranks_work_once(run):
    """At tp2 x cp2 on ``ulysses`` a rank computes its block's products and
    its ``H/(tp·cp)`` heads' attention over the whole sequence: the FLOPs
    a step summed over the tp and cp ranks equal one process's on the same
    global batch, the one-hot products' too."""
    ranks, refs, _, _ = run
    rec = _records(ranks[0]["cli_benchmark"])[-1]
    one = refs["bench"]
    assert rec["device_count"] == 4
    assert rec["model_tflops_per_step"] == pytest.approx(
        one["model_tflops_per_step"], rel=1e-9)
    assert rec["onehot_tflops_per_step"] == pytest.approx(
        one["onehot_tflops_per_step"], rel=1e-12)


def test_tp2_cp2_save_restores_on_one_rank_bit_for_bit(run):
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    ranks, _, _, tmp = run
    _, trainer = ts.port_trainer("gpt2", None)
    state = trainer.init(0)
    with CheckpointManager(str(tmp / "ckpt")) as mgr:
        state, data_state = mgr.restore(state, step=STEPS)
    assert data_state == {"next_index": STEPS} and state.step == STEPS
    whole = ranks[0][SAVED]["params"]
    assert set(whole) == set(state.params)
    for k, v in whole.items():
        assert torch.equal(state.params[k], v), k


# ---------------------------------------------------------------------------
# Single process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split,concat", [(2, 1), (1, 2), (0, 2)])
def test_all_to_all_matches_a_gather_and_a_slice(split, concat):
    """4 virtual ranks of a cp group: rank c's block of ``concat`` in, its
    block of ``split`` out, and the gradient of a weighted sum is the
    whole's gradient's block."""
    n = 4
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn(4, 8, 12, 3, generator=gen, dtype=torch.float64)
    weight = torch.randn(whole.shape, generator=gen, dtype=torch.float64)

    def block(t, dim, c):
        return t.narrow(dim, c * t.shape[dim] // n, t.shape[dim] // n)

    def fn(mesh):
        c = mesh.coords["cp"]
        x = block(whole, concat, c).clone().requires_grad_(True)
        y = comms.all_to_all_dim(x, mesh, "cp", split, concat)
        (y * block(weight, split, c)).sum().backward()
        return y.detach(), x.grad

    for c, (y, g) in enumerate(ts.lockstep(n, fn, cp=n)):
        assert torch.equal(y, block(whole, split, c))
        assert torch.equal(g, block(weight, concat, c))


@pytest.mark.parametrize("heads,seq,tp,cp", [
    (8, 32, 2, 4), (6, 32, 2, 4), (12, 30, 1, 4), (16, 197, 1, 2)])
def test_check_ulysses_shapes_gives_jax_messages(heads, seq, tp, cp):
    from distributeddeeplearning_tpu.parallel import sp_ulysses as jsp

    try:
        jsp.check_ulysses_shapes(heads, seq, tp, cp)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            sp_ulysses.check_ulysses_shapes(heads, seq, tp, cp)
        assert str(err.value) == str(e)
    else:
        sp_ulysses.check_ulysses_shapes(heads, seq, tp, cp)


def test_reshard_heads_match_jax_constraint_on_8_devices():
    """The heads each (tp, cp) rank holds after the flip equal JAX's
    ``heads_attn -> ('tp', 'cp')`` placement of ``ulysses_reshard`` under
    jit on a tp2 x cp4 mesh of 8 CPU devices."""
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import sharding as jsharding
    from distributeddeeplearning_tpu.parallel import sp_ulysses as jsp
    from helpers import mesh_of

    tp, cp, heads, seq = 2, 4, 16, 8
    # Each element says its head and its position: 100 * head + position.
    code = (100 * np.arange(heads)[None, :]
            + np.arange(seq)[:, None]).astype(np.float32)  # [seq, heads]
    jmesh = mesh_of(tp=tp, cp=cp)
    x = jnp.broadcast_to(jnp.asarray(code)[None, :, :, None],
                         (2, seq, heads, 4))
    with jsharding.activation_mesh(jmesh):
        y = jax.jit(lambda q: jsp.ulysses_reshard(q, q, q)[0])(x)
    want = {}
    for s in y.addressable_shards:
        pos = np.argwhere(jmesh.devices == s.device)[0]
        at = dict(zip(jmesh.axis_names, pos))
        want[int(at["tp"]), int(at["cp"])] = np.asarray(s.data)[0, :, :, 0]

    def fn(mesh):
        t, c = mesh.coords["tp"], mesh.coords["cp"]
        h, n = heads // tp, seq // cp
        block = torch.from_numpy(code[c * n:(c + 1) * n, t * h:(t + 1) * h])
        q = block[None, :, :, None].expand(2, n, h, 4).contiguous()
        out = sp_ulysses.ulysses_reshard(q, q, q, mesh)[0]
        assert out.shape == (2, seq, heads // (tp * cp), 4)
        return (t, c), out[0, :, :, 0].numpy()

    got = dict(ts.lockstep(tp * cp, fn, tp=tp, cp=cp))
    assert set(got) == set(want)
    for at, w in want.items():
        np.testing.assert_array_equal(got[at], w, err_msg=str(at))


def test_ring_over_one_rank_matches_the_flash_core():
    """``mesh.cp=1``: the ring is one local visit, as JAX's shard_map over a
    one-rank axis is, and equals the flash core's plain version."""
    from distributeddeeplearning_tpu_torch.models.transformer import (
        attention_core,
    )

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 24, 3, 16, generator=gen).requires_grad_(True)
               for _ in range(3))
    w = torch.randn(2, 24, 3, 16, generator=gen)
    mesh = Mesh({"cp": 1})

    def run(impl):
        out = attention_core(q, k, v, causal=True, dtype=torch.float32,
                             impl=impl, mesh=mesh)
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        return out, grads

    want, wgrads = run("flash")
    for impl in ("ring", "ring_pallas"):
        got, grads = run(impl)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        for g, wg in zip(grads, wgrads):
            torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_cli_trains_a_ring_over_one_rank(impl):
    argv = ["train", "--config",
            f"{ROOT}/distributeddeeplearning_tpu_torch/configs/gpt2_owt.py",
            "--device", "cpu"]
    for o in ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
              "model.kwargs.max_len=64", "data.vocab_size=256",
              "data.seq_len=64", "data.batch_size=2", "train.steps=1",
              "model.kwargs.dtype=float32", f"model.kwargs.attn_impl={impl}"]:
        argv += ["--override", o]
    assert cli.main(argv) == 0


@pytest.mark.parametrize("impl", ["ring", "ring_pallas", "ulysses",
                                  "ulysses_flash"])
def test_vit_197_tokens_under_cp_raise_jax_error(impl):
    core = "ring" if impl.startswith("ring") else "ulysses"
    with pytest.raises(ValueError, match=rf"^{core}: seq_len=197 not "
                       r"divisible by cp=2$"):
        models.get_model("vit", mesh=Mesh({"cp": 2}), attn_impl=impl,
                         device="meta")


@pytest.mark.parametrize("impl", ["ring", "ring_pallas", "ulysses_flash"])
def test_a_masked_bert_on_a_maskless_core_raises_jax_error(impl):
    """The ring cores and ``ulysses_flash`` take mask=None: BERT's padded
    rows raise the reference's ``NotImplementedError`` on one rank."""
    model = models.get_model("bert", size="tiny", vocab_size=32, max_len=16,
                             attn_impl=impl, mesh=Mesh({"cp": 1}))
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.zeros(2, 8, dtype=torch.long)
    mask = torch.ones(2, 8, dtype=torch.int32)
    mask[1, 5:] = 0
    msg = "ulysses_flash" if impl == "ulysses_flash" else "ring attention"
    with pytest.raises(NotImplementedError, match=rf"^{msg} supports "
                       "mask=None and no active attention-dropout$"):
        model(tokens, mask)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_heads_that_tp_cp_do_not_divide_raise_jax_error(name):
    """6 heads over cp4: JAX's ``num_heads % (tp*cp)`` message at the
    first forward, before any all-to-all."""
    kw = dict(num_heads=6, embed_dim=96, vocab_size=32, max_len=16)
    if name == "llama":
        kw["num_kv_heads"] = 6
    mesh = Mesh({"cp": 4})
    model = models.get_model(name, size="tiny", attn_impl="ulysses",
                             mesh=mesh, **kw)
    model.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"^ulysses: num_heads=6 not "
                       r"divisible by tp\*cp=4$"):
        model(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("name", ["gpt2", "llama", "gpt2_moe", "llama_moe",
                                  "bert"])
def test_ulysses_on_one_rank_equals_the_plain_core(name):
    """``mesh.cp=1``: no flip, the core alone (the reference's shard_map
    over a one-rank axis), for every model that takes the Ulysses cores."""
    kw = dict(size="tiny", vocab_size=64, max_len=32)
    kw.update(MOE if "moe" in name else {})
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 64, (2, 16), generator=gen)
    outs = []
    for impl in ("xla", "ulysses", "ulysses_flash"):
        model = models.get_model(name, attn_impl=impl, mesh=Mesh({"cp": 1}),
                                 **kw)
        model.init_weights(torch.Generator().manual_seed(0))
        outs.append(model(tokens).float())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=1e-5, atol=1e-5)


def test_dropout_under_cp_is_refused_by_name():
    """Active dropout over cp ranks on the Ulysses plain core, no longer
    refused: each rank's masks are its blocks of the one-rank masks (its
    cp block of the sequence for the embeddings and residuals, its heads
    over (tp, cp) for the probabilities), so 2 cp ranks (threads) give the
    logits of one process from the same generator, block for block."""
    kw = dict(size="tiny", vocab_size=32, max_len=16, dropout_rate=0.1)
    tokens = torch.randint(0, 32, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    one = models.get_model("gpt2", attn_impl="xla", **kw)
    one.init_weights(torch.Generator().manual_seed(0))
    want = one(tokens, train=True,
               generator=torch.Generator().manual_seed(3))
    plain = one(tokens)

    def fn(mesh):
        model = models.get_model("gpt2", attn_impl="ulysses", mesh=mesh,
                                 **kw)
        model.init_weights(torch.Generator().manual_seed(0))
        c = mesh.coords["cp"]
        return model(tokens[:, 4 * c:4 * (c + 1)], train=True,
                     generator=torch.Generator().manual_seed(3))

    got = torch.cat(ts.lockstep(2, fn, cp=2), dim=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (want - plain).abs().max() > 1e-2  # the masks are live
