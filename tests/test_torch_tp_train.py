"""Tensor parallelism of the port's Trainer against the JAX package's
Trainer on one device (the setting of JAX's ``tests/test_tp_fsdp.py``,
``tests/torch_sharded.py``): 5 steps of the tiny GPT-2 at tp=4, at tp=2
(beside dp=2) and with Megatron sequence parallelism at tp=2, and of the
tiny Llama (4 query heads over 2 KV heads) at tp=2 and with sequence
parallelism, on 4 gloo ranks spawned once. Each run's losses and final
params (gathered whole) match JAX's within rtol 2e-4 / atol 2e-5, every
rank logs the same losses, and more than half the model's elements sit in
leaves cut over tp (``sharded_fraction``: parity alone passes with
replicated leaves)."""

import numpy as np
import pytest
import torch

import torch_sharded as ts

JOBS = {
    "gpt2_tp4": ("gpt2", dict(dp=1, tp=4), {}),
    "gpt2_tp2": ("gpt2", dict(dp=2, tp=2), {}),
    "gpt2_sp_tp2": ("gpt2", dict(dp=2, tp=2), {"sequence_parallel": True}),
    "llama_tp2": ("llama", dict(dp=2, tp=2), {}),
    "llama_sp_tp2": ("llama", dict(dp=2, tp=2), {"sequence_parallel": True}),
}


def _worker(rank, world, port, tmp, inits):
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    inits = torch.load(inits)
    out = {}
    for job, (name, axes, kw) in JOBS.items():
        mesh = build_mesh(MeshConfig(**axes))
        r = ts.port_run(name, mesh, inits[name], **kw)
        out[job] = {k: r[k] for k in ("losses", "params", "fraction",
                                      "coords")}
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tptrain")
    inits = {name: ts.port_init(name) for name in ("gpt2", "llama")}
    torch.save(inits, tmp / "inits.pt")
    ranks, jax_ref = ts.spawn(
        _worker, 4, tmp, str(tmp / "inits.pt"),
        parent=lambda: {n: ts.jax_run(n, init) for n, init in inits.items()})
    return ranks, jax_ref


@pytest.mark.parametrize("job", list(JOBS))
def test_losses_and_params_match_jax(run, job):
    ranks, ref = run
    name = JOBS[job][0]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], ref[name]["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
    ts.assert_params_close(ranks[0][job]["params"], ref[name]["params"])


@pytest.mark.parametrize("job", list(JOBS))
def test_tp_is_real_and_the_ranks_agree(run, job):
    ranks, _ = run
    assert all(r[job]["losses"] == ranks[0][job]["losses"] for r in ranks)
    assert all(r[job]["fraction"]["tp"] > 0.5 for r in ranks)
    assert all(r[job]["fraction"]["fsdp"] == 0.0 for r in ranks)
    assert ranks[0][job]["losses"][-1] < ranks[0][job]["losses"][0]
