"""The port's Llama against the JAX package's ``models/llama.py``.

The tiny Llama (2 layers, 4 query heads over 2 KV heads, embed 64,
head_dim 16, vocab 256) on the CPU, where the port's flash wrappers run
their plain versions and JAX's flash kernel runs in Pallas interpret mode:

- ``rope_tables``, ``apply_rope`` and ``RMSNorm`` against JAX's, fp32,
  within 1e-6;
- the logits on the JAX init's tree with every leaf redrawn from a seeded
  numpy generator (so no logit is near zero), carried across by
  ``weights.from_jax_params``: fp32 within 1e-5 on the xla and flash
  cores, with the chunked head on and off and the embedding tied and
  untied; bf16 within two bf16 roundings of the logits;
- against an HF ``LlamaForCausalLM`` built from a ``LlamaConfig`` through
  the port's ``hf_port.port_llama``, at JAX's own tolerance (atol 2e-4,
  rtol 1e-4);
- GQA equals MHA with the KV projections repeated group-major;
- 5 steps of ``configs/llama_lm.py`` cut to the tiny size (fp32, flash,
  ``adamw_fused``, chunked head, clip) from the JAX Trainer's init and
  optimizer state, in both Trainers: losses within 1e-4 relative, params
  within 1e-5. The run uses lr 1e-3: Adam's first updates are g / (|g| +
  eps), so an embedding element whose gradient is near eps moves by a
  share of lr that its rounding decides (3e-5 apart at lr 1e-2, 3e-6 at
  1e-3). remat 'full' equals 'none'; 'dots' and the ulysses cores are
  refused as the reference refuses them;
- cp=2: two gloo ranks (``ring``, then ``ring_pallas``) against one
  process, which pins rank 1's RoPE offset;
- serving: the port's engine against the live JAX engine on the same
  weights and prompts, greedy tokens identical with the fp and the int8
  pool and each read path; ``cli serve``, ``cli train``, ``cli eval`` and
  ``cli benchmark`` on the config at the tiny size;
- the port's config is the JAX package's, field for field.
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

from distributeddeeplearning_tpu import config as jax_config
from distributeddeeplearning_tpu import data as jax_data
from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu.config import ServingConfig as JaxServing
from distributeddeeplearning_tpu.models import llama as jax_llama
from distributeddeeplearning_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxEngine,
)
from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
from distributeddeeplearning_tpu.train import get_task as jax_get_task
from distributeddeeplearning_tpu.train import make_optimizer as jax_make_opt
from distributeddeeplearning_tpu_torch import cli, data, models, train
from distributeddeeplearning_tpu_torch.config import (
    ServingConfig,
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.models import llama
from distributeddeeplearning_tpu_torch.serving import Request, ServingEngine
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    opt_state_from_jax,
)

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/llama_lm.py"
KW = dict(size="tiny", vocab_size=256, max_len=64)
TOKENS = np.random.default_rng(0).integers(0, 256, (2, 17), np.int32)
# llama_lm at the tiny size, fp32, a schedule short enough to move.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=64", "data.batch_size=4",
    "data.n_distinct=2", "optim.lr=1e-3", "optim.warmup_steps=2",
    "train.steps=5", "train.head_chunk=16",
]


def _host(tree):
    return jax.tree.map(np.asarray, nn.meta.unbox(tree))


@functools.lru_cache(maxsize=None)
def _redrawn(tie: bool):
    """The JAX init's tree (``tie_embeddings=tie``) with every leaf redrawn
    from a seeded generator: RMSNorm scales near one, the rest 0.05 x
    standard normal."""
    jm = jax_models.get_model("llama", **KW, tie_embeddings=tie)
    params = _host(jm.init(jax.random.PRNGKey(0), TOKENS)["params"])
    rng = np.random.default_rng(1)

    def redraw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            return 1.0 + 0.1 * noise
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(redraw, params)


def _port(params, **kw):
    m = models.get_model("llama", **KW, **kw)
    m.load_state_dict(from_jax_params(params), strict=True)
    return m


def _jax_out(params, tokens=TOKENS, **kw):
    jm = jax_models.get_model("llama", **KW, **kw)
    return jm.apply({"params": params}, jnp.asarray(tokens))


def _logits(out):
    if isinstance(out, dict):
        return np.asarray(out["hidden"], np.float32) @ np.asarray(
            out["emb"], np.float32).T
    return np.asarray(out, np.float32)


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(2)
    B, L, H, D = 3, 11, 4, 16
    positions = (rng.integers(0, 900, (B, L)) if per_row
                 else np.arange(L) + 5).astype(np.int32)
    x = rng.standard_normal((B, L, H, D)).astype(np.float32)
    jcos, jsin = jax_llama.rope_tables(jnp.asarray(positions), D, 10000.0)
    cos, sin = llama.rope_tables(torch.from_numpy(positions), D, 10000.0)
    assert cos.dtype == torch.float32 and cos.shape == jcos.shape
    np.testing.assert_allclose(cos.numpy(), jcos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), jsin, rtol=0, atol=1e-6)
    want = jax_llama.apply_rope(jnp.asarray(x), jcos, jsin)
    got = llama.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jax_llama.RMSNorm(1e-6).apply({"params": {"scale": scale}},
                                         jnp.asarray(x))
    norm = llama.RMSNorm(64, 1e-6, torch.float32)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    got = norm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# logits: JAX, HF, bf16, GQA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tie", [False, True])
def test_parameter_names_and_init_follow_the_flax_tree(tie):
    m = models.get_model("llama", **KW, tie_embeddings=tie)
    m.init_weights(torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in from_jax_params(
        _redrawn(tie)).items()}
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == want
    assert ("lm_head" in want) != tie
    assert not any(k.endswith("bias") for k in want)
    assert bool((m.norm.scale == 1).all())
    assert abs(m.embed.embedding.std().item() / 0.02 - 1) < 0.05


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_fp32_logits_match_jax(attn_impl, chunked, tie):
    params = _redrawn(tie)
    kw = dict(attn_impl=attn_impl, chunked_head=chunked, tie_embeddings=tie)
    want = _jax_out(params, **kw)
    got = _port(params, **kw)(torch.from_numpy(TOKENS))
    if chunked:
        assert set(got) == set(want) == {"hidden", "emb"}
        np.testing.assert_allclose(got["emb"].detach().numpy(), want["emb"],
                                   rtol=0, atol=0)
        got = {k: v.detach().numpy() for k, v in got.items()}
    else:
        assert got.dtype == torch.float32 and got.shape == (2, 17, 256)
        got = got.detach()
    want, got = _logits(want), _logits(got)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_bf16_logits_match_jax(attn_impl):
    """bf16 compute over the same fp32 weights: both packages round the
    projections, the residual stream and the head's output to bf16 (8 bits
    of mantissa), so the logits (|x| up to ~2) may sit two bf16 roundings
    apart: rtol 2**-6 plus atol 1e-2."""
    params = _redrawn(False)
    kw = dict(attn_impl=attn_impl, dtype="bfloat16")
    want = np.asarray(_jax_out(params, attn_impl=attn_impl,
                               dtype=jnp.bfloat16), np.float32)
    got = _port(params, **kw)(torch.from_numpy(TOKENS))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2 ** -6,
                               atol=1e-2)


@pytest.mark.parametrize("tie", [False, True])
def test_logits_match_hf(tie):
    from transformers import LlamaConfig, LlamaForCausalLM

    from distributeddeeplearning_tpu_torch.hf_port import (
        port_llama,
        validate_params,
    )

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=tie)).eval()
    params = port_llama(hf)
    model = models.get_model("llama", **KW, tie_embeddings=tie)
    validate_params(model, params)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        want = hf(torch.from_numpy(TOKENS).long()).logits
        got = model(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-4)


def test_gqa_equals_mha_with_repeated_kv_projections():
    """A kv_heads=2 model equals a kv_heads=4 (MHA) model whose key and
    value kernels are the GQA ones repeated group-major: query head
    g * 2 + i reads kv head g."""
    params = _redrawn(False)
    mha = {**params}
    for i in range(2):
        blk = dict(mha[f"block_{i}"])
        blk["attn"] = {
            name: ({"kernel": np.repeat(leaf["kernel"], 2, axis=1)}
                   if name in ("key", "value") else leaf)
            for name, leaf in blk["attn"].items()}
        mha[f"block_{i}"] = blk
    gqa_out = _port(params)(torch.from_numpy(TOKENS))
    mha_out = _port(mha, num_kv_heads=4)(torch.from_numpy(TOKENS))
    torch.testing.assert_close(gqa_out, mha_out, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_trainer_matches_jax_for_five_steps(mesh1):
    cfg = apply_overrides(load_config(CONFIG), TINY)
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    assert (model.attn_impl, model.chunked_head) == ("flash", True)
    assert cfg.optim.name == "adamw_fused" and cfg.optim.grad_clip == 1.0
    o = cfg.optim
    jtx = jax_make_opt(
        o.name, o.lr, b1=o.b1, b2=o.b2, weight_decay=o.weight_decay,
        warmup_steps=o.warmup_steps, schedule=o.schedule,
        total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    jm = jax_models.get_model("llama", **KW, attn_impl="flash",
                              chunked_head=True)
    jtrainer = JaxTrainer(jm, jtx, jax_get_task("lm", head_chunk=16), mesh1,
                          donate=False)
    jds = jax_data.SyntheticTokens(**cfg.data.dataset_kwargs())
    jstate = jtrainer.init(0, jds.batch(0))

    state = trainer.init(cfg.train.seed)
    model.load_state_dict(from_jax_params(_host(jstate.params)), strict=True)
    state.opt_state = opt_state_from_jax(_host(jstate.opt_state),
                                         state.opt_state)
    j_losses = []
    for batch in jax_data.sharded_batches(
            (jds.batch(i) for i in range(5)), mesh1):
        jstate, m = jtrainer.train_step(jstate, batch)
        j_losses.append(float(m["loss"]))
    state, hist = train.fit(trainer, state,
                            data.prefetch(dataset.iter_from(0), "cpu"),
                            steps=5, log_every=1, log_fn=lambda m: None)
    assert j_losses[-1] < j_losses[0]
    np.testing.assert_allclose([r["loss"] for r in hist], j_losses,
                               rtol=1e-4)
    for k, v in from_jax_params(_host(jstate.params)).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def _logits_and_grads(remat, attn_impl):
    m = _port(_redrawn(False), remat=remat, attn_impl=attn_impl)
    out = m(torch.from_numpy(TOKENS), train=True)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad((out * out).sum(), list(m.parameters()))
    return out.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_full_gives_equal_logits_and_gradients(attn_impl):
    want_out, want_g = _logits_and_grads("none", attn_impl)
    out, g = _logits_and_grads("full", attn_impl)
    torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
    for k, v in want_g.items():
        assert v.abs().max() > 0, k
        torch.testing.assert_close(g[k], v, rtol=1e-5, atol=1e-7, msg=k)


def test_remat_dots_is_refused_with_the_reference_error():
    with pytest.raises(ValueError) as jerr:
        _jax_out(_redrawn(False), remat="dots")
    with pytest.raises(ValueError) as err:
        models.get_model("llama", **KW, remat="dots")
    assert str(err.value) == str(jerr.value) == "unknown remat 'dots'"
    cfg = apply_overrides(load_config(CONFIG), TINY + ["train.remat=dots"])
    with pytest.raises(ValueError, match="unknown remat 'dots'"):
        cli.build_all(cfg, "cpu")
    cfg = apply_overrides(load_config(CONFIG), TINY + ["train.remat=full"])
    assert cli.build_all(cfg, "cpu")[0].remat == "full"


@pytest.mark.parametrize("impl", ["ulysses", "ulysses_flash"])
def test_ulysses_is_refused_by_name(impl):
    """Held since the Ulysses cores were ported
    (``tests/test_torch_ulysses.py``): the composition builds and its
    forward at the tiny size equals the plain core's (one rank: K and V
    repeated, no flip)."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    tokens = torch.randint(0, KW["vocab_size"], (2, 16),
                           generator=torch.Generator().manual_seed(0))
    outs = []
    for core in ("xla", impl):
        m = models.get_model("llama", **KW, attn_impl=core,
                             mesh=Mesh({"cp": 1}))
        m.init_weights(torch.Generator().manual_seed(0))
        outs.append(m(tokens))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# cp=2 over gloo
# ---------------------------------------------------------------------------

CP = ["model.kwargs.chunked_head=False", "optim.name=adamw",
      "optim.schedule=constant", "optim.warmup_steps=0",
      "train.zero1=False", "mesh.dp=1"]


def _fit(cfg, mesh):
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    state = trainer.init(cfg.train.seed)
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), "cpu")
    state, hist = train.fit(trainer, state, batches, steps=cfg.train.steps,
                            log_every=1, log_fn=lambda m: None)
    return ([r["loss"] for r in hist],
            {k: p.detach().clone() for k, p in state.params.items()})


def _cp_worker(rank, port, out_dir):
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
    out = {}
    for impl in ("ring", "ring_pallas"):
        cfg = apply_overrides(load_config(CONFIG), TINY + CP + [
            "mesh.cp=2", f"model.kwargs.attn_impl={impl}"])
        mesh = build_mesh(cfg.mesh)
        out[impl] = (mesh.coords["cp"], *_fit(cfg, mesh))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def cp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llama_cp2")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_cp_worker, args=(port, str(tmp)), nprocs=2,
                                join=True)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_cp2_matches_one_process(cp2, impl):
    """2 ranks at cp=2, each holding half of every sequence, against one
    process on the flash core: losses within 1e-4 relative, params within
    1e-5, the ranks bit-equal. Rank 1's RoPE positions start at L / 2."""
    one = _fit(apply_overrides(load_config(CONFIG), TINY + CP), None)
    assert [r[impl][0] for r in cp2] == [0, 1]
    losses, params = cp2[0][impl][1:]
    assert one[0][-1] < one[0][0]
    np.testing.assert_allclose(losses, one[0], rtol=1e-4)
    assert cp2[1][impl][1] == losses
    for k, v in one[1].items():
        assert torch.equal(cp2[1][impl][2][k], params[k]), k
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_rope_offset_of_a_cp_rank(monkeypatch):
    """A cp rank's block of the sequence rotates at its global positions:
    rank 1 of cp=2 over 8 tokens a rank takes positions 8 .. 15."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    seen = []
    real = llama.rope_tables
    monkeypatch.setattr(llama, "rope_tables",
                        lambda p, *a: seen.append(p) or real(p, *a))
    monkeypatch.setattr(llama, "attention_core", lambda q, k, v, **kw: q)
    m = models.get_model("llama", **KW, attn_impl="ring",
                         mesh=Mesh({"cp": 2}, 1))
    m.init_weights(torch.Generator().manual_seed(0))
    m(torch.zeros(1, 8, dtype=torch.long))
    assert torch.equal(seen[0], torch.arange(8, 16))


# ---------------------------------------------------------------------------
# serving and the CLI
# ---------------------------------------------------------------------------

_PALLAS = dict(slots=3, block_size=8, hbm_budget_mb=8, max_seq_len=48,
               prompt_buckets=(8, 16))


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    return clock


@pytest.mark.parametrize("attn_kernel", ["reference", "pallas"])
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_greedy_tokens_match_the_jax_engine(kv_quant, attn_kernel):
    """5 requests over 3 lanes (lanes retire and refill mid-flight, the
    prompts span both buckets): greedy tokens identical per request. The
    pallas read path runs the paged decode kernel (on the CPU its plain
    version) with num_rep = 2."""
    params = _redrawn(False)
    rng = np.random.default_rng(42)
    prompts = [list(map(int, rng.integers(1, 256, n)))
               for n in (5, 9, 3, 12, 7)]
    kw = dict(kv_quant=kv_quant, attn_kernel=attn_kernel, **_PALLAS)
    jeng = JaxEngine(jax_models.get_model("llama", **KW), params,
                     JaxServing(**kw), clock=_fake_clock())
    teng = ServingEngine(_port(params), ServingConfig(**kw),
                         clock=_fake_clock(), device="cpu")
    assert teng.model.num_kv_heads == 2 and teng.model.num_heads == 4
    for p in prompts:
        jeng.submit(JaxRequest(prompt=p, max_new_tokens=11))
        teng.submit(Request(prompt=p, max_new_tokens=11))
    jdone, tdone = jeng.run(), teng.run()
    assert len(tdone) == len(prompts)
    for i, (j, t) in enumerate(zip(jdone, tdone)):
        assert t.generated == j.generated, f"request {i}"
        assert t.slot == j.slot
    assert teng.num_blocks == jeng.num_blocks
    assert teng.calls["decode"] == jeng.calls["decode"]


def _main(cmd, *overrides, extra=()):
    argv = [cmd, "--config", CONFIG, "--device", "cpu", *extra]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    return cli.main(argv)


def test_cli_serve_on_the_llama_config(capsys):
    assert _main("serve", "model.kwargs.attn_impl=xla",
                 "serving.prompt_buckets=(16,32)",
                 "serving.attn_kernel=pallas", "serving.kv_quant=int8",
                 extra=["--prompt", "hello", "--prompt", "grouped queries",
                        "--max-new-tokens", "6"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("no checkpoint found")
    rec = json.loads(lines[-1])
    assert [r["prompt"] for r in rec["results"]] == ["hello",
                                                     "grouped queries"]
    assert all(r["new_tokens"] == 6 for r in rec["results"])
    assert rec["stats"]["attn_kernel"] == "pallas"
    assert rec["stats"]["device"] == "cpu"


def test_cli_train_eval_and_benchmark_on_the_llama_config(capsys, tmp_path):
    extra = ["train.steps=2", "train.log_every=1", "train.save_every=2",
             f"train.checkpoint_dir={tmp_path}", "train.eval_batches=1"]
    assert _main("train", *extra) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert _main("eval", *extra) == 0
    out = capsys.readouterr().out.splitlines()
    assert "evaluating checkpoint at step 2" in out
    assert math.isfinite(json.loads(out[-1])["eval_loss"])
    assert _main("benchmark") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "llama_lm_throughput"
    assert rec["unit"] == "tokens/sec/chip" and rec["platform"] == "cpu"
    assert rec["value"] == pytest.approx(4 * 64 * rec["steps_per_sec"],
                                         rel=1e-3)


def test_config_is_the_jax_package_s():
    ours = load_config(CONFIG)
    theirs = jax_config.load_config("configs/llama_lm.py")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
