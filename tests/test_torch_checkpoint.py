"""Checkpoint / resume of the port (``checkpoint.py``), after the JAX
package's ``tests/test_checkpoint.py``.

On the tiny GPT-2 at fp32 (flash core, ``adamw_fused``, warmup-cosine,
clip 1.0, weight decay 0.1):
- 4 steps, save, a fresh trainer restores, 4 more: equal to 8 straight
  steps bit for bit (losses, params, moments, count), on one process and
  on 2 gloo ranks with ZeRO-1;
- a corrupt latest step is quarantined and the restore falls back to the
  step before it, and training on saves that step afresh, on one process
  and on 2 ranks whose managers list the directory before and after the
  quarantine; a half-written step is never listed; ``max_to_keep``;
- cross-mesh: a checkpoint saved at dp=2 with ZeRO-1 restores at dp=1 to
  the saving ranks' state bit for bit, and one saved at dp=1 restores onto
  each dp=2 rank's shards bit for bit; both then train on within 1e-4 of
  the straight run;
- a JAX ``TrainState`` carried into the port (``weights.state_from_jax``)
  continues with JAX's losses (1e-4), and lands on ZeRO-1 shards bit for
  bit;
- ``cli train`` resumes from its checkpoint, and ``cli serve`` serves the
  restored weights: the greedy completion equals the JAX engine's on the
  same params.
One spawn of 2 gloo ranks serves every multi-rank case.
"""

import contextlib
import datetime
import io
import json
import os
import socket

import numpy as np
import pytest
import torch

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
from distributeddeeplearning_tpu_torch.parallel.zero import ZeroState

torch.set_num_threads(2)

CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
STEPS = 8
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=32", "data.batch_size=8",
    "data.n_distinct=4", "optim.lr=1e-2", "optim.warmup_steps=2",
    "train.head_chunk=16", f"train.steps={STEPS}",
]


def _cfg(*overrides):
    return apply_overrides(load_config(CONFIG), TINY + list(overrides))


def _build(mesh=None, seed=0):
    cfg = _cfg("mesh.dp=2" if mesh is not None else "mesh.dp=1")
    _, trainer, dataset = cli.build_all(cfg, "cpu", mesh)
    return trainer, dataset, trainer.init(seed)


def _fit(trainer, dataset, state, stop, mesh=None, **kw):
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(state.step), mesh), "cpu")
    return train.fit(trainer, state, batches, steps=stop, log_every=1,
                     log_fn=lambda m: None, **kw)


def _snapshot(state, hist):
    """Losses, params and the moments (this rank's shards under ZeRO-1) of
    a run, as CPU copies."""
    opt = state.opt_state

    def copy(tree):
        return {k: v.detach().clone() for k, v in tree.items()}

    return {"losses": [r["loss"] for r in hist], "params": copy(state.params),
            "mu": copy(opt.mu), "nu": copy(opt.nu), "count": opt.count,
            "step": state.step}


def _resumed(directory, stop, mesh=None):
    """A fresh trainer (another seed's weights) restores the latest step
    of ``directory`` and trains to ``stop``: (state right after the
    restore, the run's snapshot)."""
    trainer, dataset, state = _build(mesh, seed=5)
    with CheckpointManager(directory) as ckpt:
        state, data_state = ckpt.restore(state)
    assert data_state["next_index"] == state.step
    restored = _snapshot(state, [])
    state, hist = _fit(trainer, dataset, state, stop, mesh)
    return restored, _snapshot(state, hist)


def _first_half(directory, mesh=None):
    import torch.distributed as dist

    trainer, dataset, state = _build(mesh)
    with CheckpointManager(directory) as ckpt:
        state, hist = _fit(trainer, dataset, state, STEPS // 2, mesh,
                           ckpt=ckpt, save_every=STEPS // 2)
    if mesh is not None:  # rank 0's write is on disk before any rank reads
        dist.barrier()
    return _snapshot(state, hist)


def _refit_past_fallback(directory, mesh=None, rank=0):
    """Steps 2 and 4 saved, step 4 corrupted, a fresh trainer restores
    (falling back to step 2) and trains to step 4 again, saving every 2
    steps: (the steps on disk, the trained state's snapshot). On 2 ranks,
    rank 0's manager lists the directory and quarantines step 4 before
    rank 1's manager lists it."""
    import torch.distributed as dist

    trainer, dataset, state = _build(mesh)
    with CheckpointManager(directory) as ckpt:
        _fit(trainer, dataset, state, 4, mesh, ckpt=ckpt, save_every=2)
    if mesh is not None:
        dist.barrier()
    if rank == 0:
        with CheckpointManager(directory) as ckpt:
            assert ckpt.corrupt_latest_for_test() == 4
    trainer, dataset, state = _build(mesh, seed=5)
    ckpt = None
    for turn in range(1 if mesh is None else 2):
        if turn == rank:
            ckpt = CheckpointManager(directory)
            state, _ = ckpt.restore(state)
            assert state.step == 2
        if mesh is not None:
            dist.barrier()
    with ckpt:
        state, hist = _fit(trainer, dataset, state, 4, mesh, ckpt=ckpt,
                           save_every=2)
    if mesh is not None:
        dist.barrier()
    return ckpt.all_steps(), _snapshot(state, hist)


def _worker(rank, port, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # A short timeout, so that a rank which skips a collective its peer
    # takes fails the test rather than hanging it.
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    assert init_distributed("cpu")  # joins the group above
    mesh = build_mesh(_cfg("mesh.dp=2").mesh)
    trainer, dataset, state = _build(mesh)
    out = {"straight": _snapshot(*_fit(trainer, dataset, state, STEPS,
                                       mesh))}
    out["first"] = _first_half(os.path.join(tmp, "dp2"), mesh)
    out["resumed"] = _resumed(os.path.join(tmp, "dp2"), STEPS, mesh)[1]
    out["from_dp1"], out["from_dp1_run"] = _resumed(
        os.path.join(tmp, "dp1"), STEPS, mesh)
    out["fallback"] = _refit_past_fallback(os.path.join(tmp, "fallback"),
                                           mesh, rank)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def straight():
    """8 straight steps on one process."""
    trainer, dataset, state = _build()
    return _snapshot(*_fit(trainer, dataset, state, STEPS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dp=1 first half (its checkpoint in ``dp1``), then the 2 ranks'
    runs, which save into ``dp2`` and restore ``dp1``."""
    tmp = tmp_path_factory.mktemp("ckpt")
    first = _first_half(str(tmp / "dp1"))
    torch.multiprocessing.spawn(_worker, args=(_free_port(), str(tmp)),
                                nprocs=2, join=True)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return tmp, first, ranks


def _assert_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_is_bit_exact_on_one_process(tmp_path, straight):
    first = _first_half(str(tmp_path))
    restored, run = _resumed(str(tmp_path), STEPS)
    assert restored["step"] == 4 and restored["count"] == 4
    for key in ("params", "mu", "nu"):
        _assert_equal(restored[key], first[key])
        _assert_equal(run[key], straight[key])
    assert first["losses"] + run["losses"] == straight["losses"]
    assert run["count"] == STEPS


def test_resume_is_bit_exact_across_ranks(runs):
    _, _, ranks = runs
    for res in ranks:
        assert res["first"]["losses"] + res["resumed"]["losses"] == (
            res["straight"]["losses"])
        for key in ("params", "mu", "nu"):
            _assert_equal(res["resumed"][key], res["straight"][key])


def _layout(rank, params):
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroLayout

    return ZeroLayout(params, Mesh({"dp": 2}, rank))


def test_dp2_checkpoint_restores_at_dp1(runs, straight):
    """The moments saved by ZeRO-1 ranks come back whole and exact."""
    tmp, _, ranks = runs
    restored, run = _resumed(str(tmp / "dp2"), STEPS)
    saved = [r["first"] for r in ranks]
    _assert_equal(restored["params"], saved[0]["params"])
    lay = _layout(0, saved[0]["params"])
    for key in ("mu", "nu"):
        whole = lay.views({g: torch.cat([s[key][g] for s in saved])
                           for g in lay.names})
        _assert_equal(restored[key], whole)
    assert restored["count"] == 4
    np.testing.assert_allclose(run["losses"], straight["losses"][4:],
                               rtol=1e-4)


def test_dp1_checkpoint_restores_onto_dp2_shards(runs, straight):
    _, first, ranks = runs
    for rank, res in enumerate(ranks):
        got = res["from_dp1"]
        _assert_equal(got["params"], first["params"])
        lay = _layout(rank, first["params"])
        for key in ("mu", "nu"):
            _assert_equal(got[key], lay.shard(first[key]))
        assert got["count"] == 4
        np.testing.assert_allclose(res["from_dp1_run"]["losses"],
                                   straight["losses"][4:], rtol=1e-4)
        for k, v in straight["params"].items():
            if not k.endswith("attn.key.bias"):
                np.testing.assert_allclose(res["from_dp1_run"]["params"][k],
                                           v, rtol=0, atol=1e-5, err_msg=k)


def test_restore_falls_back_past_a_corrupt_latest_step(tmp_path, capsys):
    trainer, dataset, state = _build()
    with CheckpointManager(str(tmp_path)) as ckpt:
        _fit(trainer, dataset, state, 4, ckpt=ckpt, save_every=2)
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.all_steps() == [2, 4]
    assert ckpt.corrupt_latest_for_test() == 4
    with pytest.raises(EOFError):  # an explicit step restores or raises
        ckpt.restore(_build(seed=1)[2], step=4)
    state, data_state = ckpt.restore(_build(seed=1)[2])
    assert state.step == 2 and data_state == {"next_index": 2}
    assert "falling back" in capsys.readouterr().err
    assert ckpt.latest_step() == 2
    assert os.path.isdir(tmp_path / "4.corrupt")
    ckpt.close()


def _assert_step_on_disk(directory, step, snap):
    saved = torch.load(os.path.join(directory, str(step), "state.pt"),
                       weights_only=True)
    assert saved["step"] == step
    _assert_equal(saved["params"], snap["params"])


def test_training_past_a_fallback_saves_the_quarantined_step(tmp_path,
                                                            straight):
    steps, snap = _refit_past_fallback(str(tmp_path))
    assert steps == [2, 4] and os.path.isdir(tmp_path / "4.corrupt")
    assert snap["step"] == 4
    assert snap["losses"] == straight["losses"][2:4]
    _assert_step_on_disk(str(tmp_path), 4, snap)


def test_ranks_save_the_quarantined_step_after_a_fallback(runs):
    """Rank 1's manager listed the directory after rank 0 quarantined step
    4: both ranks still take the save at step 4 (a collective) and it is
    on disk again, equal to the ranks' straight run through step 4's
    save."""
    tmp, _, ranks = runs
    for res in ranks:
        steps, snap = res["fallback"]
        assert steps == [2, 4] and snap["step"] == 4
        assert snap["losses"] == res["straight"]["losses"][2:4]
    _assert_step_on_disk(str(tmp / "fallback"), 4, ranks[0]["fallback"][1])
    _assert_equal(ranks[0]["fallback"][1]["params"],
                  ranks[0]["first"]["params"])


def test_half_written_steps_are_not_listed_and_old_ones_go(tmp_path):
    trainer, dataset, state = _build()
    (tmp_path / ".tmp-9").mkdir()
    (tmp_path / ".tmp-9" / "state.pt").write_bytes(b"")
    with CheckpointManager(str(tmp_path), max_to_keep=2) as ckpt:
        state, _ = _fit(trainer, dataset, state, 3, ckpt=ckpt, save_every=1)
        assert not ckpt.save(2, state)  # no newer than the newest saved
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert ckpt.timings == []  # a manager records only its own saves
    ckpt.close()


def test_no_checkpoint_is_an_error_by_name(tmp_path):
    with CheckpointManager(str(tmp_path)) as ckpt:
        assert ckpt.latest_step() is None
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ckpt.restore(_build()[2])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer on the same config: its 6 losses and its state
    after 3 steps, pulled to the host."""
    import flax.linen as nn
    import jax
    from distributeddeeplearning_tpu import data as jax_data
    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import Trainer as JaxTrainer
    from distributeddeeplearning_tpu.train import get_task as jax_get_task
    from distributeddeeplearning_tpu.train import (
        make_optimizer as jax_make_opt,
    )

    cfg = _cfg()
    mesh = single_device_mesh()
    jm = jax_models.get_model("gpt2", size="tiny", vocab_size=256,
                              max_len=64, attn_impl="flash",
                              chunked_head=True)
    o = cfg.optim
    jtx = jax_make_opt(o.name, o.lr, b1=o.b1, b2=o.b2,
                       weight_decay=o.weight_decay,
                       warmup_steps=o.warmup_steps, schedule=o.schedule,
                       total_steps=cfg.train.steps, grad_clip=o.grad_clip)
    jtrainer = JaxTrainer(jm, jtx, jax_get_task("lm", head_chunk=16), mesh,
                          donate=False)
    ds = jax_data.SyntheticTokens(batch_size=8, seq_len=32, vocab_size=256,
                                  n_distinct=4)
    jstate = jtrainer.init(0, ds.batch(0))
    losses, at3 = [], None
    for i, batch in enumerate(jax_data.sharded_batches(
            (ds.batch(i) for i in range(6)), mesh)):
        if i == 3:
            at3 = jax.tree.map(np.asarray, nn.meta.unbox(jstate))
        jstate, m = jtrainer.train_step(jstate, batch)
        losses.append(float(m["loss"]))
    return losses, at3


def test_jax_state_carried_in_continues_with_jax_losses(jax_run):
    from distributeddeeplearning_tpu_torch.weights import state_from_jax

    losses, at3 = jax_run
    trainer, dataset, state = _build(seed=4)
    state = state_from_jax(at3, state)
    assert state.step == 3 and state.opt_state.count == 3
    _, hist = _fit(trainer, dataset, state, 6)
    np.testing.assert_allclose([r["loss"] for r in hist], losses[3:],
                               rtol=1e-4)


def test_jax_state_carried_onto_zero1_shards(jax_run):
    """Each of two dp ranks gets its shard of JAX's moments, exactly."""
    from distributeddeeplearning_tpu_torch.weights import (
        from_jax_params,
        state_from_jax,
    )

    at3 = jax_run[1]
    node = at3.opt_state
    want = {k: from_jax_params(getattr(node, k)) for k in ("mu", "nu")}
    for rank in range(2):
        mesh = Mesh({"dp": 2}, rank)
        _, _, like = _build(mesh, seed=4)
        state = state_from_jax(at3, like)
        assert isinstance(state.opt_state, ZeroState)
        lay = state.opt_state.layout
        for key in ("mu", "nu"):
            _assert_equal(getattr(state.opt_state, key),
                          lay.shard(want[key]))
        _assert_equal({k: p.detach() for k, p in state.params.items()},
                      from_jax_params(at3.params))


SERVE = ["--override", "model.kwargs.attn_impl=xla",
         "--override", "serving.prompt_buckets=(16,32)"]


def _cli(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(list(argv)) == 0
    return buf.getvalue().strip().splitlines()


def _unflatten(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


def test_cli_train_resumes_and_serve_serves_the_restored_weights(tmp_path):
    from distributeddeeplearning_tpu import models as jax_models
    from distributeddeeplearning_tpu.config import (
        ServingConfig as JaxServing,
    )
    from distributeddeeplearning_tpu.serving import Request as JaxRequest
    from distributeddeeplearning_tpu.serving import (
        ServingEngine as JaxEngine,
    )

    base = ["--config", CONFIG, "--device", "cpu"]
    for o in TINY + ["train.log_every=1", "train.save_every=2",
                     f"train.checkpoint_dir={tmp_path}"]:
        base += ["--override", o]
    first = _cli("train", *base, "--override", "train.steps=2")
    assert not any("resumed" in x for x in first)
    out = _cli("train", *base, "--override", "train.steps=4")
    assert "resumed from step 2" in out
    recs = [json.loads(x) for x in out if x.startswith("{")]
    assert [r["step"] for r in recs] == [3, 4]

    lines = _cli("serve", *base, *SERVE, "--prompt", "hello",
                 "--max-new-tokens", "8")
    assert lines[0] == "serving from checkpoint at step 4"
    rec = json.loads(lines[-1])
    assert rec["step"] == 4

    saved = torch.load(tmp_path / "4" / "state.pt", weights_only=True)
    jm = jax_models.get_model("gpt2", size="tiny", vocab_size=256,
                              max_len=64, attn_impl="xla",
                              chunked_head=True)
    eng = JaxEngine(jm, _unflatten(saved["params"]),
                    JaxServing(prompt_buckets=(16, 32)), seed=0)
    eng.submit(JaxRequest(prompt=list(b"hello"), max_new_tokens=8))
    (done,) = eng.run()
    want = bytes(t for t in done.generated if 0 <= t < 256).decode(
        "utf-8", errors="replace")
    assert len(done.generated) == 8
    assert rec["results"][0]["completion"] == want
