"""The port's pipelined models (``models/pipeline.py``) across 4 gloo ranks
at pp=2 x dp=2, against the JAX package's pipelined models on the same
weights and batches (``tests/test_torch_pipeline_models_pp4.py``: the same
cases at pp=4).

The weights are the port's own init at one rank (seed 0), handed to JAX as
its parameter tree. Every case runs the Trainer's path on each rank
(``model.pipeline_value_and_grad`` on the rank's rows, then the mean over
dp that the Trainer's gradient sync takes): the loss, and EVERY leaf's
gradient (a rank's rows of the stage leaves, the replicated leaves whole,
GPT-2's tied ``wte`` from both ends of the pipeline), held against
``jax.value_and_grad`` of the task's loss of JAX's model (``gpipe``,
``1f1b``) or JAX's ``pipeline_value_and_grad`` (``1f1b_interleaved``) on
the global batch: fp32, losses rtol 2e-5, gradients within 2e-5 of the
leaf's largest entry. The evaluation forward (the pipelined forward whose
output every rank gets, then the head on every rank) is held against JAX's
logits on each rank's rows. ``bert_pp`` runs padded rows whose two
microbatches hold different masked counts: its loss is the sum over masked
tokens over the whole batch's count, which a mean of the microbatch means
misses.

JAX's models run on a pp=S mesh over the whole batch (its pipelined
function does not depend on the mesh); the rank workers import torch and
the port only.
"""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import comms, data, models, train
from distributeddeeplearning_tpu_torch.config import MeshConfig
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed
from distributeddeeplearning_tpu_torch.weights import (
    from_jax_params,
    rank_rows,
    rank_shards,
)
from torch_sharded import pp_blocks, whole_over_pp

torch.set_num_threads(2)

B, L, VOCAB, M = 8, 16, 64, 2  # global batch, sequence, vocab, microbatches
RTOL = 2e-5
# (id, model, model kwargs, schedule, task)
CASES = [
    ("gpt2_gpipe", "gpt2_pp", {}, "gpipe", "lm"),
    ("gpt2_1f1b", "gpt2_pp", {}, "1f1b", "lm"),
    ("gpt2_interleaved", "gpt2_pp", {}, "1f1b_interleaved", "lm"),
    ("llama_untied_1f1b", "llama_pp", {}, "1f1b", "lm"),
    ("llama_tied_interleaved", "llama_pp", {"tie_embeddings": True},
     "1f1b_interleaved", "lm"),
    ("bert_gpipe", "bert_pp", {}, "gpipe", "mlm"),
    ("bert_1f1b", "bert_pp", {}, "1f1b", "mlm"),
]
IDS = [c[0] for c in CASES]


def model_kwargs(case, S):
    _, name, kw, schedule, _ = case
    layers = {"bert_pp": {"num_layers": 4}}.get(name, {})
    return dict(size="tiny", vocab_size=VOCAB, max_len=32, num_stages=S,
                num_microbatches=M, schedule=schedule, **layers, **kw)


def global_batch(task):
    """The global batch, from the port's datasets (bit for bit the JAX
    package's): LM tokens [B, L + 1], or padded MLM rows."""
    if task == "lm":
        ds = data.make_dataset("synthetic_tokens", batch_size=B, seq_len=L,
                               vocab_size=VOCAB)
    else:
        ds = data.make_dataset("synthetic_mlm", batch_size=B, seq_len=L,
                               vocab_size=VOCAB, pad_min_len=5)
    return ds.batch(0)


def _worker(rank, world, port, S, path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    with contextlib.redirect_stdout(io.StringIO()):
        assert init_distributed("cpu")
    mesh = build_mesh(MeshConfig(dp=world // S, pp=S))
    inputs = torch.load(path, weights_only=False)
    out = {"coords": mesh.coords}
    for case in CASES:
        cid, name, _, _, task_name = case
        params, batch = inputs[cid]
        model = models.get_model(name, **model_kwargs(case, S), mesh=mesh)
        # The tables are cut over pp (``vocab_pp``): a rank loads its
        # block, and its gradient's block is put back together below.
        model.load_state_dict(rank_shards(rank_rows(
            params, model.stage_rows), model.shards), strict=True)
        local = {k: torch.from_numpy(np.asarray(v)) for k, v in next(iter(
            data.sharded_batches([batch], mesh))).items()}
        task = train.get_task(task_name, mesh=mesh)
        loss, grads, metrics = model.pipeline_value_and_grad(local, task)
        names = list(grads)
        dtypes = {n: g.dtype for n, g in grads.items()}
        grads = whole_over_pp(grads, model.shards)
        synced = comms.pmean_tensors([grads[n] for n in names] + [loss],
                                     mesh, "dp")
        res = {"loss": synced[-1], "grads": dict(zip(names, synced[:-1])),
               "dtypes": dtypes, "blocks": pp_blocks(model.shards)}
        if "interleaved" not in cid:
            with torch.no_grad():
                res["logits"] = model(*task.input_fn(local))
        out[cid] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def port_init(case, S):
    """The port's weights of the case's model at S stages on one rank,
    seed 0."""
    model = models.get_model(case[1], **model_kwargs(case, S))
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def jax_tree(flat):
    """A flat state_dict -> the nested tree of numpy arrays JAX takes."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def _jax_case(case, S, batch, params):
    """(loss, flat grads, logits or None) of JAX's model at S stages on a
    pp=S mesh, from ``params`` (a flat state_dict)."""
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import models as jm
    from distributeddeeplearning_tpu.train import get_task as jget_task

    from helpers import mesh_of

    _, name, _, schedule, task_name = case
    mesh = mesh_of(pp=S)
    jmod = jm.get_model(name, **model_kwargs(case, S), mesh=mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = jget_task(task_name)
    if task_name == "lm":
        inputs = (jb["tokens"][:, :-1],)
    else:
        inputs = (jb["input_tokens"], jb["attention_mask"])
    params = jax.tree.map(jnp.asarray, jax_tree(params))
    logits = None
    if schedule == "1f1b_interleaved":
        loss, grads = jax.jit(lambda p: jmod.pipeline_value_and_grad(
            p, {"tokens": jb["tokens"]}, mesh))(params)
    else:
        def loss_fn(p):
            out = jmod.apply({"params": p}, *inputs)
            return task.loss_fn(out, jb)[0], out

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        logits = np.asarray(logits)

    def flat(tree):
        return from_jax_params(jax.tree.map(np.asarray, tree))

    return float(loss), flat(grads), logits


def run_cases(S, tmp_path):
    """Every case at pp=S on 4 ranks, JAX's references computed while the
    ranks run: (the ranks' results, JAX's by case id, the batches by case
    id)."""
    batches = {c[0]: global_batch(c[4]) for c in CASES}
    weights = {c[0]: port_init(c, S) for c in CASES}
    path = tmp_path / "inputs.pt"
    torch.save({cid: (weights[cid], batches[cid]) for cid in weights}, path)
    ctx = torch.multiprocessing.spawn(
        _worker, args=(4, _free_port(), S, str(path), str(tmp_path)),
        nprocs=4, join=False)
    jax_out = {c[0]: _jax_case(c, S, batches[c[0]], weights[c[0]])
               for c in CASES}
    while not ctx.join():
        pass
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, jax_out, batches


def check_loss_and_every_grad(run, cid):
    S, ranks, jax_out, _ = run
    j_loss, j_grads, _ = jax_out[cid]
    for r in ranks:
        s = r["coords"]["pp"]
        got = r[cid]
        np.testing.assert_allclose(float(got["loss"]), j_loss, rtol=RTOL)
        assert set(got["grads"]) == set(j_grads)
        for k, want in j_grads.items():
            want = want.numpy()
            if ".stages." in k:
                want = want[s:s + 1]
            err = np.abs(got["grads"][k].numpy() - want).max()
            assert err <= RTOL * np.abs(want).max() + 1e-7, (cid, k, s, err)
            assert got["dtypes"][k] == torch.float32


# Each model's tables (JAX's ``vocab_pp``) -> the dimension pp cuts.
TABLES = {"gpt2_pp": {"wte.embedding": 0},
          "llama_pp": {"embed.embedding": 0, "lm_head": 1},
          "bert_pp": {"word_embeddings.embedding": 0}}
EMBED = 64  # the tiny models' width


def check_table_blocks(run, cid):
    """At pp alone every rank stores its block of ``ceil(V / pp)`` rows of
    each table (and of Llama's untied head), not the whole."""
    S, ranks, _, _ = run
    case = next(c for c in CASES if c[0] == cid)
    want = {}
    for k, d in TABLES[case[1]].items():
        if k == "lm_head" and case[2].get("tie_embeddings"):
            continue
        shape = [EMBED, EMBED]
        shape[d] = -(-VOCAB // S)
        want[k] = tuple(shape)
    for r in ranks:
        assert r[cid]["blocks"] == want, (cid, r["coords"])


def check_eval_logits(run, cid):
    S, ranks, jax_out, _ = run
    logits = jax_out[cid][2]
    dp = 4 // S
    n = B // dp
    for r in ranks:
        d = r["coords"]["dp"]
        np.testing.assert_allclose(r[cid]["logits"].numpy(),
                                   logits[d * n:(d + 1) * n], rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    S = 2
    return (S, *run_cases(S, tmp_path_factory.mktemp("pp2dp2")))


@pytest.mark.parametrize("cid", IDS)
def test_loss_and_every_grad_match_jax(run, cid):
    check_loss_and_every_grad(run, cid)


@pytest.mark.parametrize("cid", [c for c in IDS if "interleaved" not in c])
def test_eval_forward_matches_jax_logits(run, cid):
    check_eval_logits(run, cid)


@pytest.mark.parametrize("cid", IDS)
def test_tables_are_cut_over_pp_alone(run, cid):
    check_table_blocks(run, cid)


def test_ranks_sit_on_the_mesh(run):
    _, ranks, _, _ = run
    assert [(r["coords"]["dp"], r["coords"]["pp"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_bert_loss_is_over_the_whole_batch_s_masked_count(run):
    """The microbatches of each rank hold different masked counts, so the
    mean of microbatch means differs from JAX's loss; the port's is JAX's
    (``check_loss_and_every_grad``)."""
    _, _, jax_out, batches = run
    import jax.numpy as jnp
    from distributeddeeplearning_tpu.train import get_task as jget_task

    batch = batches["bert_1f1b"]
    labels = batch["labels"]
    counts = (labels >= 0).reshape(2 * M, -1).sum(1)
    assert len(set(counts.tolist())) > 1, counts
    # The per-microbatch mean of the same per-token losses, from JAX's
    # own logits: not the loss.
    logits = jax_out["bert_gpipe"][2]
    task = jget_task("mlm")
    n = B // (2 * M)
    means = [float(task.loss_fn(jnp.asarray(logits[i * n:(i + 1) * n]),
                                {"labels": jnp.asarray(labels[i * n:(i + 1)
                                                              * n])})[0])
             for i in range(2 * M)]
    j_loss = jax_out["bert_gpipe"][0]
    assert abs(np.mean(means) - j_loss) > 100 * RTOL * j_loss
