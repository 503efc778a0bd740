"""The port's KV-cache generation (``generate.py``, ``cli generate``) against
the JAX package's.

On the CPU, tiny models (2 layers, vocab 97) from the JAX init carried
across by ``weights.from_jax_params``:

- greedy tokens equal to JAX's live ``generate`` exactly, for ``gpt2``,
  ``llama`` (4 query heads over 2 KV heads) and ``llama_moe`` (one-token
  prefill), with even and left-padded uneven prompts (``prompt_lens``),
  full logits and the chunked head;
- bulk prefill against one-token prefill, and the no-cache oracle (a full
  forward over the growing prefix);
- ``decode_bench``: its tokens equal ``generate``'s, its record has JAX's
  keys;
- ``_filter_logits`` against JAX's; top-k 1 sampling equals greedy;
  sampling is deterministic for a seeded generator and stays in the
  vocabulary;
- ``generate`` against the port's ``ServingEngine`` (reference route) on
  the same prompts;
- ``cli generate`` after a tiny ``cli train`` on a byte corpus: the 8-cycle
  of JAX's own test, learned and continued from uneven prompts, and the
  reference's refusals.
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import generate as jax_gen
from distributeddeeplearning_tpu import models as jax_models
from distributeddeeplearning_tpu_torch import cli, models
from distributeddeeplearning_tpu_torch.config import ServingConfig
from distributeddeeplearning_tpu_torch.generate import (
    _decode_body,
    _filter_logits,
    _make_pick,
    _prefill_body,
    decode_bench,
    generate,
    pad_prompts,
    uses_bulk_prefill,
    verify_step,
)
from distributeddeeplearning_tpu_torch.serving import Request, ServingEngine
from distributeddeeplearning_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

V = 97
KW = dict(size="tiny", vocab_size=V, max_len=64)
EVEN = np.random.default_rng(0).integers(0, V, (2, 7), np.int32)
UNEVEN = [[5, 17, 3, 88, 41, 9, 60], [72, 11, 30]]
NEW = 9


def _jax_pair(name, seed=1, **kw):
    """(JAX model, host params, port model) on the same weights: the JAX
    init's tree with every leaf redrawn from a seeded generator (norm
    scales near one, the rest 0.1 x standard normal), so the positional
    embedding weighs as much as the token one and a position off by a
    row's left padding changes the tokens."""
    jm = jax_models.get_model(name, **KW, **kw)
    tree = nn.meta.unbox(
        jm.init(jax.random.PRNGKey(seed), jnp.asarray(EVEN))["params"])
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32)
        return 1.0 + 0.1 * noise if path[-1].key == "scale" else 0.1 * noise

    params = jax.tree_util.tree_map_with_path(redraw, tree)
    tm = models.get_model(name, **KW, **kw)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm


def _oracle(tm, prompt, new):
    """No-cache greedy reference: a full forward over the growing prefix."""
    buf = torch.as_tensor(prompt).long()
    for _ in range(new):
        out = tm(buf)
        if isinstance(out, dict):
            out = out["hidden"] @ out["emb"].t()
        buf = torch.cat([buf, out[:, -1].argmax(-1)[:, None]], dim=1)
    return buf.numpy()


@pytest.mark.parametrize("chunked", [False, True], ids=["logits", "chunked"])
@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
@pytest.mark.parametrize("name", ["gpt2", "llama", "llama_moe"])
def test_greedy_tokens_match_jax_generate(name, uneven, chunked):
    jm, params, tm = _jax_pair(name, chunked_head=chunked)
    if uneven:
        prompt, lens = pad_prompts(UNEVEN)
    else:
        prompt, lens = EVEN, None
    want = jax_gen.generate(jm, params, prompt, max_new_tokens=NEW,
                            prompt_lens=lens)
    got = generate(tm, prompt, max_new_tokens=NEW, prompt_lens=lens)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not uneven and name != "llama_moe":  # see the MoE test below
        np.testing.assert_array_equal(got.numpy(), _oracle(tm, prompt, NEW))


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_left_padded_row_equals_the_row_alone(name):
    """A left-padded row's pad columns are invisible and its positions
    count from its first real token (GPT-2's learned positions would show
    an offset; Llama's RoPE is relative, so only the mask would)."""
    _, _, tm = _jax_pair(name)
    prompt, lens = pad_prompts(UNEVEN)
    batch = generate(tm, prompt, max_new_tokens=NEW, prompt_lens=lens)
    for i, row in enumerate(UNEVEN):
        alone = generate(tm, [row], max_new_tokens=NEW)
        torch.testing.assert_close(batch[i, prompt.shape[1]:],
                                   alone[0, len(row):], rtol=0, atol=0)


def test_cache_positions_count_from_each_row_s_first_token():
    from distributeddeeplearning_tpu_torch.models.transformer import KVCache

    cache = KVCache.empty(1, 2, 8, 1, 4, torch.float32, "cpu",
                          start=[0, 3])
    assert cache.positions(4).tolist() == [[0, 1, 2, 3], [0, 0, 0, 0]]
    cache.cache_index = 4
    assert cache.positions(1).tolist() == [[4], [1]]


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_bulk_prefill_equals_one_token_prefill(name):
    _, _, tm = _jax_pair(name)
    prompt, lens = pad_prompts(UNEVEN)
    p = torch.as_tensor(prompt).long()
    starts = torch.as_tensor(prompt.shape[1] - lens).long()
    pick = _make_pick(1.0, 0, 0.0, False, False, None)
    out = {}
    for bulk in (True, False):
        buf, cache = _prefill_body(tm, p, pick, starts, NEW, bulk)
        P = p.shape[1]
        out[bulk] = _decode_body(tm, buf, cache, pick, P, P + NEW,
                                 P if bulk else 0)
    assert uses_bulk_prefill(tm)
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=0)
    np.testing.assert_array_equal(out[True].numpy()[1, 4:],
                                  _oracle(tm, [UNEVEN[1]], NEW)[0])


def test_moe_decodes_one_token_at_a_time():
    """A decode step routes one token a row and never drops; the oracle's
    batched forward routes whole rows, so its capacity is raised to the
    row (capacity_factor = experts / selected) for it to drop nothing."""
    _, _, tm = _jax_pair("llama_moe", capacity_factor=4.0)
    assert not uses_bulk_prefill(tm)
    got = generate(tm, EVEN, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), _oracle(tm, EVEN, NEW))


def test_decode_bench_tokens_and_record_keys():
    jm, params, tm = _jax_pair("gpt2")
    prompt, lens = pad_prompts(UNEVEN)
    _, jrec = jax_gen.decode_bench(jm, params, prompt, max_new_tokens=4,
                                   prompt_lens=lens)
    want = generate(tm, prompt, max_new_tokens=4, prompt_lens=lens)
    got, rec = decode_bench(tm, prompt, max_new_tokens=4, prompt_lens=lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(rec) == set(jrec)
    for k in ("decode_steps_timed", "generated_tokens", "prompt_tokens",
              "reps", "bulk_prefill"):
        assert rec[k] == jrec[k], k
    assert rec["decode_tokens_per_sec"] > 0
    with pytest.raises(ValueError, match="max_new_tokens >= 2"):
        decode_bench(tm, prompt, max_new_tokens=1)
    with pytest.raises(ValueError, match="reps >= 3"):
        decode_bench(tm, prompt, max_new_tokens=4, reps=2)


def test_decode_bench_replays_the_sampling_stream():
    _, _, tm = _jax_pair("gpt2")
    kw = dict(max_new_tokens=6, temperature=0.9, top_p=0.9)
    want = generate(tm, EVEN, generator=torch.Generator().manual_seed(5),
                    **kw)
    got, _ = decode_bench(tm, EVEN, generator=torch.Generator().manual_seed(5),
                          **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("top_k,top_p", [
    (2, 0.0), (0, 0.6), (3, 0.5), (0, 0.0), (200, 0.0),
    ([1, 4], [0.0, 0.7]),
])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(3).standard_normal((2, 11)).astype(
        np.float32)
    want = jax_gen._filter_logits(jnp.asarray(logits), jnp.asarray(top_k),
                                  jnp.asarray(top_p, jnp.float32))
    got = _filter_logits(torch.from_numpy(logits), torch.as_tensor(top_k),
                         torch.as_tensor(top_p, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_one_sampling_equals_greedy():
    _, _, tm = _jax_pair("llama")
    greedy = generate(tm, EVEN, max_new_tokens=NEW)
    sampled = generate(tm, EVEN, max_new_tokens=NEW, temperature=1.3,
                       top_k=1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(sampled, greedy, rtol=0, atol=0)


def test_sampling_is_seeded_and_in_vocabulary():
    _, _, tm = _jax_pair("gpt2")

    def run(seed):
        return generate(tm, EVEN, max_new_tokens=NEW, temperature=1.0,
                        top_p=0.95,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < V
    np.testing.assert_array_equal(a[:, :EVEN.shape[1]].numpy(), EVEN)


def test_argument_checks():
    _, _, tm = _jax_pair("gpt2")
    with pytest.raises(ValueError, match="requires generator"):
        generate(tm, EVEN, max_new_tokens=2, temperature=0.5)
    with pytest.raises(ValueError, match="only apply when sampling"):
        generate(tm, EVEN, max_new_tokens=2, top_k=3)
    with pytest.raises(ValueError, match="max_new_tokens must be >= 1"):
        generate(tm, EVEN, max_new_tokens=0)
    with pytest.raises(ValueError, match=r"prompt_lens must be \[batch\]"):
        generate(tm, EVEN, max_new_tokens=2, prompt_lens=[3])
    with pytest.raises(ValueError, match="empty prompt"):
        pad_prompts([[1], []])
    with pytest.raises(ValueError, match="exceeds max_len"):
        generate(tm, EVEN, max_new_tokens=64)


def test_verify_step_is_greedy_at_every_position():
    from distributeddeeplearning_tpu_torch.generate import new_cache

    _, _, tm = _jax_pair("gpt2")
    want = generate(tm, EVEN, max_new_tokens=4)
    cache = new_cache(tm, 2, 12, torch.zeros(2, dtype=torch.long))
    greedy = verify_step(tm, cache, want[:, :10].long())
    assert cache.cache_index == 10
    torch.testing.assert_close(greedy[:, 6:9], want[:, 7:10], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_generate_matches_the_serving_engine(name):
    """The contiguous cache against the paged one (reference route): the
    same greedy continuation of every prompt."""
    _, _, tm = _jax_pair(name)
    prompts = [[int(t) for t in p] for p in UNEVEN + [list(EVEN[0])]]
    eng = ServingEngine(tm, ServingConfig(
        slots=2, block_size=8, hbm_budget_mb=8, max_seq_len=48,
        prompt_buckets=(8, 16), attn_kernel="reference"), device="cpu")
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=NEW))
    served = {tuple(st.request.prompt): list(st.generated)
              for st in eng.run()}
    prompt, lens = pad_prompts(prompts)
    got = generate(tm, prompt, max_new_tokens=NEW, prompt_lens=lens)
    for i, p in enumerate(prompts):
        assert got[i, prompt.shape[1]:].tolist() == served[tuple(p)], i


# ---------------------------------------------------------------------------
# cli generate
# ---------------------------------------------------------------------------

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"


def _common(tmp_path):
    from distributeddeeplearning_tpu_torch.data_text import write_token_file

    tok = str(tmp_path / "corpus.tok")
    write_token_file(tok, np.frombuffer(b"abcdefgh" * 600, np.uint8)
                     .astype(np.int64), 256)
    return [
        "--config", CONFIG, "--device", "cpu",
        "--override", "model.kwargs.size=tiny",
        "--override", "model.kwargs.vocab_size=256",
        "--override", "model.kwargs.max_len=64",
        "--override", "model.kwargs.dtype=float32",
        "--override", "data.kind=token_file_lm",
        "--override", f"data.path={tok}",
        "--override", "data.batch_size=8", "--override", "data.seq_len=32",
        "--override", "optim.name=adamw", "--override", "optim.lr=0.01",
        "--override", "optim.warmup_steps=0",
        "--override", f"train.checkpoint_dir={tmp_path}/ckpt",
    ]


def test_cli_generate_from_trained_checkpoint(tmp_path, capsys):
    """JAX's end-to-end test: train the byte GPT-2 briefly on a corpus with
    a strong 8-cycle, then ``cli generate`` continues each uneven prompt's
    own cycle from the checkpoint."""
    common = _common(tmp_path)
    assert cli.main(["train", *common, "--override", "train.steps=40",
                     "--override", "train.log_every=20",
                     "--override", "train.save_every=20"]) == 0
    capsys.readouterr()
    assert cli.main(["generate", *common, "--prompt", "abcdefghabc",
                     "--prompt", "abcdefghabcdef", "--max-new-tokens", "8",
                     "--bench", "--reps", "4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "generating from checkpoint at step 40"
    rec = json.loads(out[-1])
    assert rec["step"] == 40 and rec["reps"] == 4
    assert rec["decode_tokens_per_sec"] > 0 and rec["bulk_prefill"] is True
    assert rec["results"][0]["completion"].startswith("defgh")
    assert rec["results"][1]["completion"].startswith("gh")
    # Without --bench: the same tokens, and no bench fields.
    assert cli.main(["generate", *common, "--prompt", "abcdefghabc",
                     "--prompt", "abcdefghabcdef", "--max-new-tokens",
                     "8"]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert plain["results"] == rec["results"]
    assert "decode_time_s" not in plain


@pytest.mark.parametrize("argv,match", [
    (["--prompt", "hi", "--top-k", "3"], "only apply when sampling"),
    (["--prompt", ""], "prompt must be non-empty"),
    (["--prompt", "hi", "--bench", "--max-new-tokens", "1"],
     "--bench needs --max-new-tokens >= 2"),
    (["--prompt", "hi", "--bench", "--reps", "2"], "--bench needs --reps >= 3"),
    (["--prompt", "hi", "--max-new-tokens", "63"], "exceeds model max_len"),
])
def test_cli_generate_argument_refusals(argv, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        cli.main(["generate", *_common(tmp_path), *argv])


def test_cli_generate_refuses_a_non_byte_vocab():
    with pytest.raises(ValueError, match="byte-tokenizer"):
        cli.main(["generate", "--config", CONFIG, "--device", "cpu",
                  "--override", "model.kwargs.size=tiny",
                  "--prompt", "hi", "--max-new-tokens", "2"])


def test_cli_generate_refuses_gpt2_moe():
    with pytest.raises(ValueError,
                       match="'gpt2_moe' has no KV-cache decode support"):
        cli.main(["generate", "--config",
                  "distributeddeeplearning_tpu_torch/configs/gpt2_moe.py",
                  "--device", "cpu", "--override", "model.kwargs.size=tiny",
                  "--override", "model.kwargs.vocab_size=256",
                  "--prompt", "hi", "--max-new-tokens", "2"])
