"""Context-parallel training of the port across processes, on the CPU.

Two spawns of gloo ranks, each running all its cases:
- 2 ranks, ``mesh.cp=2``, ``attn_impl='ring_pallas'`` (the kernels' plain
  versions on CPU tensors): 5 training steps of the tiny GPT-2; then
  ``ring_shift`` and its autograd transpose between the two ranks; then
  ``cli train`` under the ``torchrun`` environment;
- 4 ranks, ``mesh.dp=2`` x ``mesh.cp=2``, ``attn_impl='ring'``: 5 steps.

Each run must equal the port's single-process run and the JAX package's
``train_tiny_gpt2`` at the same mesh (``tests/helpers.py``), from the JAX
init's weights (``weights.from_jax_params``): losses within 1e-4 relative,
params within 1e-5, except the key biases (their gradient is 0 up to
rounding, and Adam moves them by noise in both packages alike). The ranks'
params must be bit-equal after the steps, and no kernel launch is counted
on the CPU. The rank workers import torch and the port only; JAX is
imported inside the test functions.
"""

import contextlib
import io
import json
import os
import socket

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, comms, data, train
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.mesh import build_mesh, init_distributed

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
STEPS = 5
# helpers.train_tiny_gpt2's run on gpt2_owt's schema: tiny GPT-2 (2 layers,
# width 64, vocab 256), fp32, batch 16 x 32, 4 distinct batches, plain AdamW
# at a constant lr 1e-3, no clip, no weight decay.
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "model.kwargs.chunked_head=False", "data.vocab_size=256",
    "data.seq_len=32", "data.batch_size=16", "data.n_distinct=4",
    "optim.name=adamw", "optim.lr=1e-3", "optim.b2=0.999",
    "optim.weight_decay=0.0", "optim.schedule=constant",
    "optim.warmup_steps=0", "optim.grad_clip=0.0", "train.zero1=False",
    f"train.steps={STEPS}",
]


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def _train(cfg, mesh, device, weights):
    """build_all + fit on this rank, from ``weights``: (losses, params)."""
    model, trainer, dataset = cli.build_all(cfg, device, mesh)
    state = trainer.init(cfg.train.seed)
    model.load_state_dict(weights, strict=True)
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), device)
    state, hist = train.fit(trainer, state, batches, steps=cfg.train.steps,
                            log_every=1, log_fn=lambda m: None)
    return ([r["loss"] for r in hist],
            {k: p.detach().clone() for k, p in state.params.items()})


def _worker(rank, world, port, case, weights_path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert init_distributed("cpu")
    weights = torch.load(weights_path)
    dp, cp, impl = case
    cfg = _cfg(f"mesh.dp={dp}", f"mesh.cp={cp}",
               f"model.kwargs.attn_impl={impl}")
    mesh = build_mesh(cfg.mesh)
    out = {"coords": mesh.coords, "init": buf.getvalue()}
    out["losses"], out["params"] = _train(cfg, mesh, "cpu", weights)
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas

    out["launches"] = dict(ring_attention_pallas.LAUNCHES)
    if world == 2:
        r = mesh.coords["cp"]
        x = torch.full((3,), float(r), requires_grad=True)
        (y,) = comms.ring_shift([x], mesh, "cp", shift=-1)
        (g,) = torch.autograd.grad((y * (10.0 + r)).sum(), (x,))
        out["shift"] = (y.detach(), g)
        argv = ["train", "--config", CONFIG, "--device", "cpu",
                "--sync-steps"]
        for o in TINY + ["train.steps=2", "train.log_every=1", "mesh.dp=1",
                         "mesh.cp=2", f"model.kwargs.attn_impl={impl}"]:
            argv += ["--override", o]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0  # destroys the process group
        out["cli"] = buf.getvalue()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, case, weights, tmp_path):
    path = tmp_path / "weights.pt"
    torch.save(weights, path)
    torch.multiprocessing.spawn(
        _worker, args=(world, _free_port(), case, str(path), str(tmp_path)),
        nprocs=world, join=True)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init's weights (seed 0) as a state_dict."""
    import jax
    import flax.linen as nn
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    from helpers import train_tiny_gpt2

    _, state = train_tiny_gpt2(single_device_mesh(), n_steps=0)
    return from_jax_params(jax.tree.map(np.asarray,
                                        nn.meta.unbox(state.params)))


def _jax_reference(mesh_axes, impl):
    import jax
    import flax.linen as nn
    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    from helpers import mesh_of, train_tiny_gpt2

    losses, state = train_tiny_gpt2(mesh_of(**mesh_axes), attn_impl=impl,
                                    n_steps=STEPS)
    return losses, from_jax_params(jax.tree.map(
        np.asarray, nn.meta.unbox(state.params)))


def _assert_params_close(got, want):
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("attn.key.bias"):
            assert np.abs(a).max() < 1e-3 and np.abs(b).max() < 1e-3, k
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def single(jax_init):
    """The port's single-process run (flash core) from the same weights."""
    return _train(_cfg("model.kwargs.attn_impl=flash"), None, "cpu",
                  jax_init)


@pytest.fixture(scope="module")
def cp2(jax_init, tmp_path_factory):
    """(the 2 ranks' results, JAX's run) at cp=2 with ring_pallas."""
    ranks = _spawn(2, (1, 2, "ring_pallas"), jax_init,
                   tmp_path_factory.mktemp("cp2"))
    return ranks, _jax_reference({"cp": 2}, "ring_pallas")


@pytest.fixture(scope="module")
def dp2cp2(jax_init, tmp_path_factory):
    """(the 4 ranks' results, JAX's run) at dp=2 x cp=2 with ring."""
    ranks = _spawn(4, (2, 2, "ring"), jax_init,
                   tmp_path_factory.mktemp("dp2cp2"))
    return ranks, _jax_reference({"dp": 2, "cp": 2}, "ring")


RUNS = ["cp2", "dp2cp2"]


@pytest.mark.parametrize("run", RUNS)
def test_ranks_sit_on_the_mesh(run, request):
    ranks, _ = request.getfixturevalue(run)
    got = [(r["coords"]["dp"], r["coords"]["cp"]) for r in ranks]
    assert got == {"cp2": [(0, 0), (0, 1)],
                   "dp2cp2": [(0, 0), (0, 1), (1, 0), (1, 1)]}[run]
    assert "dist: gloo, " + str(len(ranks)) + " ranks on the cpu" in (
        ranks[0]["init"])
    assert all(r["init"] == "" for r in ranks[1:])


@pytest.mark.parametrize("run", RUNS)
def test_losses_match_jax_and_single_process(run, request, single):
    ranks, (j_losses, _) = request.getfixturevalue(run)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], j_losses, rtol=1e-4)
        np.testing.assert_allclose(res["losses"], single[0], rtol=1e-4)


@pytest.mark.parametrize("run", RUNS)
def test_params_match_jax_and_single_process(run, request, single):
    ranks, (_, j_params) = request.getfixturevalue(run)
    _assert_params_close(ranks[0]["params"], j_params)
    _assert_params_close(ranks[0]["params"], single[1])


@pytest.mark.parametrize("run", RUNS)
def test_params_are_bit_equal_across_ranks(run, request):
    ranks, _ = request.getfixturevalue(run)
    for res in ranks[1:]:
        for k, p in res["params"].items():
            assert torch.equal(p, ranks[0]["params"][k]), k


@pytest.mark.parametrize("run", RUNS)
def test_plain_route_counts_no_launch(run, request):
    ranks, _ = request.getfixturevalue(run)
    for res in ranks:
        assert res["launches"] == {"ring_step": 0, "ring_dq": 0,
                                   "ring_dkv": 0}


def test_ring_shift_and_its_transpose_across_processes(cp2):
    """shift=-1 receives from the +1 neighbour; the backward sends each
    cotangent back to the rank its tensor came from."""
    for r, res in enumerate(cp2[0]):
        y, g = res["shift"]
        assert torch.equal(y, torch.full((3,), float((r + 1) % 2)))
        assert torch.equal(g, torch.full((3,), 10.0 + (r - 1) % 2))


def test_cli_train_under_torchrun_environment(cp2):
    """Rank 0 alone prints; its train_end record carries every rank's
    report, with the losses averaged over the ranks."""
    ranks, _ = cp2
    assert ranks[1]["cli"] == ""
    text = ranks[0]["cli"]
    assert "devices: 2" in text
    recs = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    end = recs[-1]
    assert end["event"] == "train_end" and end["backend"] == "gloo"
    assert len(end["ranks"]) == 2 and len(end["step_s"]) == 2
    assert end["ranks"][0]["losses"] == end["ranks"][1]["losses"]
    assert all(set(r["launches"]) >= {"ring_step", "flash_fwd",
                                      "fused_adamw"} for r in end["ranks"])


def test_dropout_masks_do_not_depend_on_the_dp_split():
    """With dropout on, each dp rank's forward (its rows of the batch, the
    same step generator) equals the single-device forward's rows: the masks
    are drawn for the global batch and sliced, as JAX's are."""
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    kw = dict(size="tiny", vocab_size=64, max_len=16, dropout_rate=0.2)
    tok = torch.randint(0, 64, (4, 16),
                        generator=torch.Generator().manual_seed(1))

    def forward(mesh, rows):
        m = models.get_model("gpt2", mesh=mesh, **kw)
        m.init_weights(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(train.fold_in_step(0, 3))
        return m(tok[rows], train=True, generator=g)

    whole = forward(None, slice(0, 4))
    for r in range(2):
        part = forward(Mesh({"dp": 2}, r), slice(2 * r, 2 * r + 2))
        assert torch.equal(part, whole[2 * r:2 * r + 2])
