"""The pieces of the port's tensor parallelism against unsharded autograd
and the JAX package's models, on 2 gloo ranks spawned once (tp = 2):

- Megatron's f and g (``comms.identity_fwd_psum_bwd``,
  ``comms.psum_identity_bwd``) around a column- then row-parallel pair of
  products, and their sequence-parallel forms (the seq shards gathered at
  the entry, the partial sums scattered at the exit): outputs and every
  gradient against one process's autograd, in float64 within 1e-12;
- ``parallel.tp.RowParallelDense`` after a column slice of a
  ``transformer.Dense``: the bias added once, after the sum;
- the vocab-parallel embedding and ``chunked_xent`` at an uneven
  vocabulary (257 over tp = 2: the last rank's slice padded by one row)
  against ``F.embedding`` and the plain ``chunked_xent``, fp32 within
  1e-5, gradients too (the padded row's zero);
- the tiny GPT-2 and Llama (vocab 257) at tp = 2, with and without
  sequence parallelism, on the same weights as JAX's model: each rank's
  logits are JAX's columns of its vocabulary slice, and the LM loss is
  JAX's (rtol 2e-4 / atol 2e-5, JAX's ``tests/test_tp_fsdp.py``);
- Llama's GQA at tp = 2: rank r's attention output heads are heads
  ``[r H/tp, (r+1) H/tp)`` of the one-rank model's, so its query heads
  read its own KV heads under the group-major repeat.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_sharded as ts

V = 257  # uneven over tp = 2
MODEL = dict(size="tiny", vocab_size=V, max_len=64)


def _tokens():
    rng = np.random.default_rng(3)
    t = rng.integers(0, V, (2, 17))
    t[0, :4] = [0, 128, 129, V - 1]  # both slices' edges
    return t


def _marker_case():
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.standard_normal(s))
            for k, s in (("x", (2, 8, 6)), ("w1", (6, 4)), ("w2", (4, 6)),
                         ("c", (2, 8, 6)))}


def _reference_markers(case):
    leaves = {k: case[k].clone().requires_grad_() for k in ("x", "w1",
                                                             "w2")}
    y = torch.relu(leaves["x"] @ leaves["w1"]) @ leaves["w2"]
    (y * case["c"]).sum().backward()
    return y.detach(), {k: v.grad for k, v in leaves.items()}


def _markers(mesh, sp):
    from distributeddeeplearning_tpu_torch import comms

    case = _marker_case()
    r = mesh.coords["tp"]
    cols = slice(2 * r, 2 * r + 2)
    rows = slice(4 * r, 4 * r + 4)
    x = (case["x"][:, rows] if sp else case["x"]).clone().requires_grad_()
    w1 = case["w1"][:, cols].clone().requires_grad_()
    w2 = case["w2"][cols].clone().requires_grad_()
    if sp:
        h = torch.relu(comms.all_gather_fwd_reduce_scatter_bwd(x, mesh) @ w1)
        y = comms.reduce_scatter_fwd_all_gather_bwd(h @ w2, mesh)
        c = case["c"][:, rows]
    else:
        h = torch.relu(comms.identity_fwd_psum_bwd(x, mesh) @ w1)
        y = comms.psum_identity_bwd(h @ w2, mesh)
        c = case["c"]
    (y * c).sum().backward()
    return y.detach(), {"x": x.grad, "w1": w1.grad, "w2": w2.grad}


def _dense_case():
    from distributeddeeplearning_tpu_torch.models.transformer import Dense

    torch.manual_seed(0)
    fc_in = Dense((6,), (8,), torch.float32)
    fc_out = Dense((8,), (6,), torch.float32)
    for p in (*fc_in.parameters(), *fc_out.parameters()):
        torch.nn.init.normal_(p)
    return fc_in, fc_out, torch.randn(3, 5, 6)


def _dense(mesh):
    from distributeddeeplearning_tpu_torch.models.transformer import Dense
    from distributeddeeplearning_tpu_torch.parallel import tp

    fc_in, fc_out, x = _dense_case()
    r = mesh.coords["tp"]
    col = Dense((6,), (4,), torch.float32)
    row = tp.RowParallelDense((4,), (6,), torch.float32, mesh=mesh)
    with torch.no_grad():
        col.kernel.copy_(fc_in.kernel[:, 4 * r:4 * r + 4])
        col.bias.copy_(fc_in.bias[4 * r:4 * r + 4])
        row.kernel.copy_(fc_out.kernel[4 * r:4 * r + 4])
        row.bias.copy_(fc_out.bias)
    y = row(torch.relu(col(tp.enter(x, mesh, False))))
    y.sum().backward()
    return y.detach(), {"col.kernel": col.kernel.grad,
                        "row.kernel": row.kernel.grad,
                        "row.bias": row.bias.grad}


def _vocab_case():
    rng = np.random.default_rng(1)
    return {"table": torch.from_numpy(
                (rng.standard_normal((V, 8)) * 0.3).astype(np.float32)),
            "hidden": torch.from_numpy(
                rng.standard_normal((2, 17, 8)).astype(np.float32)),
            "ids": torch.from_numpy(_tokens())}


def _vocab(mesh):
    from distributeddeeplearning_tpu_torch.ops.chunked_xent import (
        chunked_xent,
        head_output,
    )
    from distributeddeeplearning_tpu_torch.parallel import tp

    case = _vocab_case()
    shard = tp.VocabShard.of(mesh, V)
    rows = -(-V // 2)
    local = torch.zeros(rows, 8)
    local[:shard.valid] = case["table"][shard.lo:shard.lo + shard.valid]
    table = local.clone().requires_grad_()
    emb = tp.vocab_parallel_embed(case["ids"], table, shard, torch.float32,
                                  False)
    emb.sum().backward()
    embed_grad = table.grad.clone()
    table.grad = None
    hidden = case["hidden"].clone().requires_grad_()
    per_tok = chunked_xent(head_output(tp.enter(hidden, mesh, False), table,
                                       vocab=shard), case["ids"],
                           seq_chunk=5)
    per_tok.sum().backward()
    return {"shard": (shard.lo, shard.valid), "embed": emb.detach(),
            "embed_grad": embed_grad, "per_tok": per_tok.detach(),
            "hidden_grad": hidden.grad, "table_grad": table.grad}


def _model(name, mesh, init, sp):
    """Each rank's logits of its vocabulary slice and the LM loss, and
    (Llama) the input of block 0's out projection."""
    from distributeddeeplearning_tpu_torch import models, train
    from distributeddeeplearning_tpu_torch.weights import rank_shards

    kw = {"sequence_parallel": True} if sp else {}
    model = models.get_model(name, **MODEL, mesh=mesh, **kw)
    model.load_state_dict(rank_shards(init, model.shards), strict=True)
    heads = []
    hook = model.get_submodule(
        "block_0.attn.out" if name == "llama" else "h.block_0.attn.out"
    ).register_forward_hook(lambda m, a, o: heads.append(a[0].detach()))
    batch = {"tokens": torch.from_numpy(_tokens())}
    task = train.get_task("lm", mesh=mesh)
    with torch.no_grad():
        out = model(*task.input_fn(batch))
        loss = float(task.loss_fn(out, batch)[0])
    hook.remove()
    logits = torch.einsum("ble,ve->blv", out["hidden"],
                          out["emb"]).float().detach()
    return {"logits": logits, "vocab": (out["vocab"].lo, out["vocab"].valid),
            "loss": loss, "heads": heads[0]}


def _worker(rank, world, port, tmp, inits):
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    inits = torch.load(inits)
    mesh = build_mesh(MeshConfig(dp=1, tp=2))
    out = {"markers": _markers(mesh, False),
           "markers_sp": _markers(mesh, True), "dense": _dense(mesh),
           "vocab": _vocab(mesh), "coords": mesh.coords}
    for name in ("gpt2", "llama"):
        for sp in (False, True):
            out[(name, sp)] = _model(name, mesh, inits[name], sp)
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _jax_models(inits):
    """JAX's logits and LM loss of each tiny model on the same weights."""
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import models as jm
    from distributeddeeplearning_tpu.train import get_task

    out = {}
    tokens = jnp.asarray(_tokens())
    for name, flat in inits.items():
        model = jm.get_model(name, **MODEL)
        logits = model.apply({"params": ts.jax_tree(flat)}, tokens[:, :-1])
        loss = get_task("lm").loss_fn(logits, {"tokens": tokens})[0]
        out[name] = (np.asarray(logits), float(loss))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from distributeddeeplearning_tpu_torch import models

    tmp = tmp_path_factory.mktemp("tp")
    inits = {}
    for name in ("gpt2", "llama"):
        m = models.get_model(name, **MODEL)
        m.init_weights(torch.Generator().manual_seed(0))
        inits[name] = {k: v.detach().clone()
                       for k, v in m.state_dict().items()}
    torch.save(inits, tmp / "inits.pt")
    ranks, ref = ts.spawn(_worker, 2, tmp, str(tmp / "inits.pt"),
                          parent=lambda: _jax_models(inits))
    return ranks, ref, inits


@pytest.mark.parametrize("sp", [False, True])
def test_megatron_markers_match_unsharded_autograd(run, sp):
    ranks, _, _ = run
    y, grads = _reference_markers(_marker_case())
    for r in ranks:
        i = r["coords"]["tp"]
        got_y, got = r["markers_sp" if sp else "markers"]
        rows = slice(4 * i, 4 * i + 4)
        want_y, want_x = (y[:, rows], grads["x"][:, rows]) if sp else (
            y, grads["x"])
        torch.testing.assert_close(got_y, want_y, rtol=0, atol=1e-12)
        torch.testing.assert_close(got["x"], want_x, rtol=0, atol=1e-12)
        cols = slice(2 * i, 2 * i + 2)
        torch.testing.assert_close(got["w1"], grads["w1"][:, cols], rtol=0,
                                   atol=1e-12)
        torch.testing.assert_close(got["w2"], grads["w2"][cols], rtol=0,
                                   atol=1e-12)


def test_column_then_row_parallel_dense(run):
    ranks, _, _ = run
    fc_in, fc_out, x = _dense_case()
    y = fc_out(torch.relu(fc_in(x)))
    y.sum().backward()
    for r in ranks:
        i = r["coords"]["tp"]
        got_y, got = r["dense"]
        torch.testing.assert_close(got_y, y.detach(), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["col.kernel"],
                                   fc_in.kernel.grad[:, 4 * i:4 * i + 4])
        torch.testing.assert_close(got["row.kernel"],
                                   fc_out.kernel.grad[4 * i:4 * i + 4])
        # Added once, after the sum: its gradient is the whole one.
        torch.testing.assert_close(got["row.bias"], fc_out.bias.grad)


def test_vocab_parallel_embedding_and_xent_at_an_uneven_vocab(run):
    from distributeddeeplearning_tpu_torch.ops.chunked_xent import (
        chunked_xent,
        head_output,
    )

    ranks, _, _ = run
    case = _vocab_case()
    table = case["table"].clone().requires_grad_()
    emb = F.embedding(case["ids"], table)
    emb.sum().backward()
    embed_grad = table.grad.clone()
    table.grad = None
    hidden = case["hidden"].clone().requires_grad_()
    per_tok = chunked_xent(head_output(hidden, table), case["ids"],
                           seq_chunk=5)
    per_tok.sum().backward()
    assert [r["vocab"]["shard"] for r in ranks] == [(0, 129), (129, 128)]
    for r in ranks:
        got = r["vocab"]
        lo, n = got["shard"]
        torch.testing.assert_close(got["embed"], emb.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["embed_grad"][:n],
                                   embed_grad[lo:lo + n])
        torch.testing.assert_close(got["per_tok"], per_tok.detach(),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["hidden_grad"], hidden.grad,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["table_grad"][:n],
                                   table.grad[lo:lo + n], rtol=1e-5,
                                   atol=1e-5)
        # The padded row of the last slice takes no gradient.
        assert not got["table_grad"][n:].any()


@pytest.mark.parametrize("name", ["gpt2", "llama"])
@pytest.mark.parametrize("sp", [False, True])
def test_logits_and_loss_at_tp2_match_jax(run, name, sp):
    ranks, ref, _ = run
    logits, loss = ref[name]
    for r in ranks:
        got = r[(name, sp)]
        lo, n = got["vocab"]
        np.testing.assert_allclose(got["logits"][..., :n].numpy(),
                                   logits[..., lo:lo + n], rtol=ts.RTOL,
                                   atol=ts.ATOL)
        np.testing.assert_allclose(got["loss"], loss, rtol=ts.RTOL,
                                   atol=ts.ATOL)


def test_gqa_heads_read_their_own_kv_heads_per_rank(run):
    """Tiny Llama: 4 query heads over 2 KV heads (rep 2). At tp = 2 rank r
    holds query heads {2r, 2r+1} and KV head r; its attention outputs are
    the one-rank model's heads 2r and 2r+1."""
    from distributeddeeplearning_tpu_torch import models

    ranks, _, inits = run
    model = models.get_model("llama", **MODEL)
    model.load_state_dict(inits["llama"])
    heads = []
    model.block_0.attn.out.register_forward_hook(
        lambda m, a, o: heads.append(a[0].detach()))
    with torch.no_grad():
        model(torch.from_numpy(_tokens())[:, :-1])
    whole = heads[0]
    assert whole.shape[2] == 4 and model.block_0.attn.rep == 2
    for r in ranks:
        i = r["coords"]["tp"]
        for sp in (False, True):
            got = r[("llama", sp)]["heads"]
            assert got.shape[2] == 2
            torch.testing.assert_close(got, whole[:, :, 2 * i:2 * i + 2],
                                       rtol=1e-5, atol=1e-6)
