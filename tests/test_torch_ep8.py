"""Expert parallelism composed with the other mesh axes, on 8 gloo ranks
spawned once, against the JAX package's Trainer on one device: the
compositions JAX's ``tests/test_moe.py`` holds (``:125``, ``:130``,
``:224``, ``:277``, ``:282``), in the setting of ``tests/test_torch_ep.py``
(the tiny MoE models at capacity factor 0.5, drops in every routed layer;
weight decay 0.1 and clip 0.05, so the sharded norm carries weight):

- ``ep4_dp2``: gpt2_moe, one expert a rank, the batch over dp;
- ``ep2_tp2_dp2``: gpt2_moe, the experts' hidden units over tp;
- ``ep2_tp2_dp2_sp``: llama_moe with sequence parallelism, its 2 KV heads
  over tp (GQA), each routed layer gathering the sequence first;
- ``ep2_fsdp2_dp2``: gpt2_moe, the experts' and the router's ``embed``
  dimension over fsdp, the batch over dp x fsdp;
- ``ep2_cp2_dp2``: gpt2_moe on the ``ring`` core, each row routed across
  two cp blocks.

Each run's losses, final params (gathered whole), ``aux_loss`` and
``moe_dropped_frac`` match JAX's within rtol 2e-4 / atol 2e-5, and every
rank logs the same losses.
"""

import numpy as np
import pytest
import torch

import torch_sharded as ts

MOE = dict(num_experts=4, capacity_factor=0.5)
JOBS = {
    "ep4_dp2": ("gpt2_moe", dict(dp=2, ep=4), {}),
    "ep2_tp2_dp2": ("gpt2_moe", dict(dp=2, tp=2, ep=2), {}),
    "ep2_tp2_dp2_sp": ("llama_moe", dict(dp=2, tp=2, ep=2),
                       {"sequence_parallel": True}),
    "ep2_fsdp2_dp2": ("gpt2_moe", dict(dp=2, fsdp=2, ep=2), {}),
    "ep2_cp2_dp2": ("gpt2_moe", dict(dp=2, cp=2, ep=2),
                    {"attn_impl": "ring"}),
}


def _worker(rank, world, port, tmp):
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    inits = torch.load(f"{tmp}/inits.pt")
    out = {}
    for job, (name, axes, kw) in JOBS.items():
        mesh = build_mesh(MeshConfig(**axes))
        r = ts.port_run(name, mesh, inits[name], model_kw=MOE, **kw)
        out[job] = {k: r[k] for k in ("losses", "metrics", "params",
                                      "fraction")}
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep8")
    inits = {n: ts.port_init(n, **MOE) for n in ("gpt2_moe", "llama_moe")}
    torch.save(inits, tmp / "inits.pt")
    ranks, refs = ts.spawn(
        _worker, 8, tmp, parent=lambda: {
            n: ts.jax_run(n, init, **MOE) for n, init in inits.items()})
    return ranks, refs


@pytest.mark.parametrize("job", list(JOBS))
def test_losses_and_params_match_jax(run, job):
    ranks, refs = run
    ref = refs[JOBS[job][0]]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], ref["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
        assert r[job]["losses"] == ranks[0][job]["losses"]
    ts.assert_params_close(ranks[0][job]["params"], ref["params"])


@pytest.mark.parametrize("job", list(JOBS))
def test_aux_loss_and_dropped_fraction_match_jax(run, job):
    ranks, refs = run
    ref = refs[JOBS[job][0]]
    for key in ("aux_loss", "moe_dropped_frac"):
        want = [m[key] for m in ref["metrics"]]
        for r in ranks:
            np.testing.assert_allclose([m[key] for m in r[job]["metrics"]],
                                       want, rtol=ts.RTOL, atol=ts.ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("job", list(JOBS))
def test_every_live_axis_cuts_leaves(run, job):
    ranks, _ = run
    axes = JOBS[job][1]
    for r in ranks:
        for a in ("tp", "fsdp", "ep"):
            if axes.get(a, 1) > 1:
                assert r[job]["fraction"][a] > 0.4, (job, a)
            else:
                assert r[job]["fraction"][a] == 0.0
