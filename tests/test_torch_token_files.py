"""The port's token-file path against the JAX package's ``data_text.py`` and
``prepare_data.py``. Each test writes its own corpus.

- ``write_token_file`` / ``read_token_file`` round trips at uint16 and
  uint32, the range errors, and the files byte for byte against JAX's;
- ``TokenFileLM`` and ``TokenFileMLM`` batches equal JAX's bit for bit over
  indices that cross an epoch boundary (the remainder dropped, the next
  epoch's permutation);
- ``prepare_data --tokenizer byte`` writes the same file bytes as JAX's,
  in-process and as ``python -m``; ``hf:`` and ``grain_token_file_lm`` are
  refused by name;
- ``cli train`` on ``configs/gpt2_owt_file.py`` at a tiny size resumes
  step-exact: steps 3 and 4 after a restore from step 2 equal the straight
  run's bit for bit;
- the ``mlm`` task's ``evaluate`` equals JAX's on ``token_file_mlm``
  batches (BERT at a small size, the same weights).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import config as jax_config
from distributeddeeplearning_tpu import data_text as jax_text
from distributeddeeplearning_tpu import prepare_data as jax_prepare
from distributeddeeplearning_tpu_torch import (
    cli,
    data,
    data_text,
    prepare_data,
    train,
)
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt_file.py"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A uint16 file of 2,000 tokens over a vocab of 300 (so the ids need
    more than a byte), written by the port."""
    path = tmp_path_factory.mktemp("tok") / "corpus.tok"
    tokens = np.random.default_rng(0).integers(0, 300, 2000)
    data_text.write_token_file(str(path), tokens, 300)
    return str(path), tokens


@pytest.mark.parametrize("vocab,width", [(300, 2), (1 << 16, 2),
                                         ((1 << 16) + 1, 4), (100_000, 4)])
def test_round_trip_and_the_same_bytes_as_jax(vocab, width, tmp_path):
    tokens = np.random.default_rng(1).integers(0, vocab, 999)
    tokens[:2] = (0, vocab - 1)
    ours, theirs = tmp_path / "ours.tok", tmp_path / "theirs.tok"
    data_text.write_token_file(str(ours), tokens, vocab)
    jax_text.write_token_file(str(theirs), tokens, vocab)
    assert ours.read_bytes() == theirs.read_bytes()
    assert os.path.getsize(ours) == 32 + width * 999
    got, got_vocab = data_text.read_token_file(str(ours))
    assert got_vocab == vocab and got.dtype.itemsize == width
    np.testing.assert_array_equal(got, tokens)


@pytest.mark.parametrize("tokens,vocab", [([0, 5, 300], 300), ([-1, 2], 10),
                                          ([1, 2], 0), ([[1, 2]], 10)])
def test_write_refuses_what_jax_refuses(tokens, vocab, tmp_path):
    with pytest.raises(ValueError) as jerr:
        jax_text.write_token_file(str(tmp_path / "j.tok"), tokens, vocab)
    with pytest.raises(ValueError) as err:
        data_text.write_token_file(str(tmp_path / "t.tok"), tokens, vocab)
    assert str(err.value) == str(jerr.value)


def test_read_refuses_a_file_that_is_not_a_token_file(tmp_path):
    bad = tmp_path / "bad.tok"
    bad.write_bytes(b"DDLTOK02" + bytes(24))
    with pytest.raises(ValueError, match="not a DDLTOK01 token file"):
        data_text.read_token_file(str(bad))
    bad.write_bytes(b"DDLTOK01")
    with pytest.raises(ValueError, match="truncated token-file header"):
        data_text.read_token_file(str(bad))


# 2000 tokens in rows of 64: 31 rows, 3 batches of 8 an epoch (7 dropped).
@pytest.mark.parametrize("index", [0, 1, 2, 3, 5, 7, 100])
@pytest.mark.parametrize("kind", ["lm", "mlm"])
def test_batches_equal_jax_s_bit_for_bit(corpus, kind, index):
    path, tokens = corpus
    kw = dict(path=path, batch_size=8, seq_len=64, seed=3)
    cls, jcls = ((data_text.TokenFileLM, jax_text.TokenFileLM) if kind == "lm"
                 else (data_text.TokenFileMLM, jax_text.TokenFileMLM))
    ours, theirs = cls(**kw).batch(index), jcls(**kw).batch(index)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype == np.int32
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    if kind == "lm":
        rows = ours["tokens"]
        assert rows.shape == (8, 65)
        starts = [int(np.flatnonzero(
            (np.lib.stride_tricks.sliding_window_view(tokens, 65)
             == row).all(1))[0]) for row in rows]
        assert all(s % 64 == 0 for s in starts)  # whole rows of the stream
    else:
        assert ours["input_tokens"].shape == (8, 64)
        assert 0.05 < (ours["labels"] >= 0).mean() < 0.3


def test_an_epoch_visits_every_row_once(corpus):
    path, _ = corpus
    ds = data_text.TokenFileLM(path=path, batch_size=8, seq_len=64, seed=3)
    epoch = np.concatenate([ds.batch(i)["tokens"] for i in range(3)])
    nxt = np.concatenate([ds.batch(i)["tokens"] for i in range(3, 6)])
    assert len({r.tobytes() for r in epoch}) == 24
    assert {r.tobytes() for r in epoch} != {r.tobytes() for r in nxt}


def test_the_kinds_are_registered_and_grain_is_refused(corpus):
    path, _ = corpus
    ds = data.make_dataset("token_file_lm", path=path, batch_size=4,
                           seq_len=32)
    assert isinstance(ds, data_text.TokenFileLM) and ds.vocab_size == 300
    assert isinstance(data.make_dataset("token_file_mlm", path=path,
                                        batch_size=4, seq_len=32),
                      data_text.TokenFileMLM)
    with pytest.raises(NotImplementedError, match="grain_token_file_lm"):
        data.make_dataset("grain_token_file_lm", path=path, batch_size=4)
    with pytest.raises(ValueError, match="requires data.path"):
        data.make_dataset("token_file_lm", path="", batch_size=4)
    with pytest.raises(ValueError, match="need >= batch_size"):
        data.make_dataset("token_file_lm", path=path, batch_size=64,
                          seq_len=64)


def test_prepare_data_writes_jax_s_bytes(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_text("héllo tokenized wörld\n" * 300, encoding="utf-8")
    ours, theirs = tmp_path / "ours.tok", tmp_path / "theirs.tok"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert prepare_data.main(["--input", str(src), "--output",
                                  str(ours)]) == 0
        assert jax_prepare.main(["--input", str(src), "--output",
                                 str(theirs), "--tokenizer", "byte"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    lines = out.getvalue().splitlines()
    assert lines[0].replace(str(ours), "X") == lines[1].replace(
        str(theirs), "X")
    by_module = tmp_path / "module.tok"
    res = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch."
         "prepare_data", "--input", str(src), "--output", str(by_module),
         "--tokenizer", "byte"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    assert by_module.read_bytes() == theirs.read_bytes()
    tokens, vocab = data_text.read_token_file(str(ours))
    assert vocab == 256 and bytes(np.asarray(tokens[:6], np.uint8)) == (
        "héllo".encode())


def test_prepare_data_refuses_hf_by_name(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_text("hello")
    with pytest.raises(NotImplementedError,
                       match=r"--tokenizer hf:gpt2: .*ROADMAP queue A14"):
        prepare_data.main(["--input", str(src), "--output",
                           str(tmp_path / "x.tok"), "--tokenizer", "hf:gpt2"])
    assert not (tmp_path / "x.tok").exists()


# ---------------------------------------------------------------------------
# cli train on the config, resumed
# ---------------------------------------------------------------------------

TINY = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
        "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
        "data.seq_len=64", "data.batch_size=4", "optim.lr=1e-3",
        "optim.warmup_steps=2", "train.head_chunk=16", "train.log_every=1"]


def _train(path, *overrides):
    argv = ["train", "--config", CONFIG, "--device", "cpu",
            "--override", f"data.path={path}"]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    lines = buf.getvalue().splitlines()
    return lines, [json.loads(x) for x in lines if x.startswith('{"loss"')]


def test_cli_train_on_a_token_file_resumes_step_exact(tmp_path):
    src = tmp_path / "corpus.txt"
    with open(os.path.join(ROOT, "README.md"), "rb") as f:
        src.write_bytes(f.read()[:20_000])
    path = tmp_path / "corpus.tok"
    with contextlib.redirect_stdout(io.StringIO()):
        prepare_data.main(["--input", str(src), "--output", str(path)])
    ckpt = tmp_path / "ckpt"
    _, straight = _train(path, "train.steps=4",
                         f"train.checkpoint_dir={tmp_path / 'none'}")
    _, first = _train(path, "train.steps=2", "train.save_every=2",
                      f"train.checkpoint_dir={ckpt}")
    lines, second = _train(path, "train.steps=4", "train.save_every=2",
                           f"train.checkpoint_dir={ckpt}")
    assert "resumed from step 2" in lines
    assert [r["step"] for r in first + second] == [1, 2, 3, 4]
    assert [r["loss"] for r in first + second] == [r["loss"]
                                                   for r in straight]
    assert straight[-1]["loss"] < straight[0]["loss"]


def test_config_is_the_jax_package_s():
    ours = load_config(CONFIG)
    theirs = jax_config.load_config("configs/gpt2_owt_file.py")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.data.kind == "token_file_lm" and ours.data.path == ""


# ---------------------------------------------------------------------------
# the mlm task's evaluate on token_file_mlm batches
# ---------------------------------------------------------------------------

BERT = dict(size="tiny", num_layers=2, num_heads=2, embed_dim=128,
            vocab_size=300, max_len=64)


def test_mlm_evaluate_matches_jax_on_token_file_batches(corpus):
    from distributeddeeplearning_tpu import data as jax_data
    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
    from distributeddeeplearning_tpu.train import evaluate as jax_evaluate
    from distributeddeeplearning_tpu.train import get_task as jax_get_task
    from distributeddeeplearning_tpu.train import (
        make_optimizer as jax_make_opt,
    )
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    path, _ = corpus
    kw = dict(path=path, batch_size=4, seq_len=64, seed=5)
    jds = jax_text.TokenFileMLM(**kw)
    mesh = single_device_mesh()
    jm = jax_models.get_model("bert", **BERT, attn_impl="flash",
                              chunked_head=True)
    jtrainer = JaxTrainer(jm, jax_make_opt("adamw", 1e-3),
                          jax_get_task("mlm", head_chunk=16), mesh,
                          donate=False)
    jstate = jtrainer.init(0, jds.batch(0))
    # 3 batches a pass: the third crosses into the second epoch.
    idx = (0, 6, 7)
    want = jax_evaluate(jtrainer, jstate, jax_data.sharded_batches(
        (jds.batch(i) for i in idx), mesh))

    model = models.get_model("bert", **BERT, attn_impl="flash",
                             chunked_head=True)
    model.load_state_dict(from_jax_params(jax.tree.map(
        np.asarray, nn.meta.unbox(jstate.params))), strict=True)
    trainer = train.Trainer(model, train.AdamW(1e-3),
                            train.get_task("mlm", head_chunk=16),
                            device="cpu")
    state = trainer.init(0)
    model.load_state_dict(from_jax_params(jax.tree.map(
        np.asarray, nn.meta.unbox(jstate.params))), strict=True)
    ds = data_text.TokenFileMLM(**kw)
    got = train.evaluate(trainer, state, data.prefetch(
        (ds.batch(i) for i in idx), "cpu"))
    assert set(got) == set(want) == {"eval_loss", "eval_masked_fraction"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
