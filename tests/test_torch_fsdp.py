"""FSDP of the port's Trainer, and its compositions with tp, dp and ZeRO-1,
against the JAX package's Trainer on one device (the setting of JAX's
``tests/test_tp_fsdp.py``, ``tests/torch_sharded.py``), on 4 gloo ranks
spawned once:

- ``fsdp2``: the tiny GPT-2 at fsdp=2 (beside dp=2), more than half its
  elements in leaves cut over fsdp;
- ``fsdp4``: fsdp=4, each rank's parameter bytes below half of one rank's
  whole model (biases and GPT-2's LayerNorms stay whole, as in JAX);
- the composition of JAX's ``test_dp2_tp2_fsdp2_composed_parity``: dp2 x
  tp2 x fsdp2 with ZeRO-1 on 8 ranks (a second spawn), and its three
  4-rank pairs, ``dp2_tp2_zero1``, ``dp2_fsdp2_zero1`` and ``tp2_fsdp2``;
- the tiny Llama at fsdp=4 (its RMSNorm scales cut too) and at tp2 x
  fsdp2;
- remat 'full' under tp and fsdp (GPT-2 at tp2 x fsdp2 and at dp2 x tp2
  with SP, Llama at tp2 x fsdp2) against JAX's ``remat='full'``, and the
  bf16 policy under fsdp (GPT-2 at fsdp=4, Llama at dp2 x fsdp2 with
  ZeRO-1) against JAX's bf16 run.

Each run's losses and final params (gathered whole) match JAX's within
rtol 2e-4 / atol 2e-5 (a bf16 run's losses within two bf16 roundings,
rtol 2**-6, as ``tests/test_torch_tp_lifecycle.py`` holds bf16 at tp=2),
and every rank logs the same losses. Beside them,
the block schedule: a block's leaves are gathered in its forward, freed
at its end and gathered again in its backward."""

import numpy as np
import pytest
import torch

import torch_sharded as ts

JOBS = {
    "fsdp2": ("gpt2", dict(dp=2, fsdp=2), {}),
    "fsdp4": ("gpt2", dict(dp=1, fsdp=4), {}),
    "dp2_tp2_zero1": ("gpt2", dict(dp=2, tp=2), {"zero1": True}),
    "dp2_fsdp2_zero1": ("gpt2", dict(dp=2, fsdp=2), {"zero1": True}),
    "tp2_fsdp2": ("gpt2", dict(dp=1, fsdp=2, tp=2), {}),
    "llama_fsdp4": ("llama", dict(dp=1, fsdp=4), {}),
    "llama_tp2_fsdp2": ("llama", dict(dp=1, fsdp=2, tp=2), {}),
    "remat_tp2_fsdp2": ("gpt2", dict(dp=1, fsdp=2, tp=2), {"remat": "full"}),
    "remat_dp2_tp2_sp": ("gpt2", dict(dp=2, tp=2),
                         {"remat": "full", "sequence_parallel": True}),
    "llama_remat_tp2_fsdp2": ("llama", dict(dp=1, fsdp=2, tp=2),
                              {"remat": "full"}),
    "bf16_fsdp4": ("gpt2", dict(dp=1, fsdp=4), {"precision": "bf16"}),
    "llama_bf16_dp2_fsdp2_zero1": ("llama", dict(dp=2, fsdp=2),
                                   {"precision": "bf16", "zero1": True}),
}
BF16_RTOL = 2 ** -6


def ref_key(job: str) -> tuple:
    """The JAX run a job is held against: (model, remat, precision)."""
    name, _, kw = JOBS[job]
    return name, kw.get("remat", "none"), kw.get("precision", "fp32")


def jax_refs(inits: dict) -> dict:
    out = {}
    for key in dict.fromkeys(ref_key(j) for j in JOBS):
        name, remat, precision = key
        kw = {"remat": remat} if remat != "none" else {}
        out[key] = ts.jax_run(name, inits[name], precision=precision, **kw)
    return out


def _gathers(mesh):
    """(leaves gathered in a forward, then with its backward, of the tiny
    GPT-2 at fsdp; how many of the leaves a block gathered outlive its
    forward, of how many)."""
    import gc
    import weakref

    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.ops.chunked_xent import (
        chunked_xent,
    )
    from distributeddeeplearning_tpu_torch.parallel import fsdp

    m = models.get_model("gpt2", **ts.MODEL, mesh=mesh)
    m.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                           .manual_seed(1))
    fsdp.reset_gathers()
    refs, register = [], fsdp._Scope.register

    def watched(self, full, args):
        refs.append(weakref.ref(full))
        return register(self, full, args)

    fsdp._Scope.register = watched
    try:
        out = m(tokens)
    finally:
        fsdp._Scope.register = register
    gc.collect()
    forward = dict(fsdp.GATHERS)
    alive = sum(r() is not None for r in refs)
    chunked_xent(out, tokens).mean().backward()
    return forward, dict(fsdp.GATHERS), (alive, len(refs))


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
                                      "bytes", "coords")}
        out[job]["opt_bytes"] = sum(
            t.numel() * t.element_size()
            for t in (*r["state"].opt_state.mu.values(),
                      *r["state"].opt_state.nu.values()))
    out["gathers"] = _gathers(build_mesh(MeshConfig(dp=1, fsdp=4)))
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    inits = {name: ts.port_init(name) for name in ("gpt2", "llama")}
    torch.save(inits, tmp / "inits.pt")
    ranks, refs = ts.spawn(_worker, 4, tmp, str(tmp / "inits.pt"),
                           parent=lambda: jax_refs(inits))
    # The fp32 runs without remat under each model's name.
    refs.update({n: refs[(n, "none", "fp32")] for n in inits})
    return ranks, refs, inits


@pytest.mark.parametrize("job", list(JOBS))
def test_losses_and_params_match_jax(run, job):
    ranks, refs, _ = run
    ref = refs[ref_key(job)]
    bf16 = ref_key(job)[2] == "bf16"
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], ref["losses"],
                                   rtol=BF16_RTOL if bf16 else ts.RTOL,
                                   atol=0 if bf16 else ts.ATOL)
        assert r[job]["losses"] == ranks[0][job]["losses"]
    if bf16:
        # bf16 is load-bearing: the fp32 run's losses differ.
        assert ranks[0][job]["losses"] != refs[JOBS[job][0]]["losses"]
        return
    ts.assert_params_close(ranks[0][job]["params"], ref["params"])


@pytest.mark.parametrize("job", list(JOBS))
def test_the_sharding_is_real(run, job):
    ranks, _, _ = run
    axes = JOBS[job][1]
    for r in ranks:
        for a in ("tp", "fsdp"):
            if axes.get(a, 1) > 1:
                # Alone each axis holds the bulk; together each still
                # holds more than JAX's composed test asks (0.4).
                assert r[job]["fraction"][a] > (0.5 if len(
                    [x for x in ("tp", "fsdp") if axes.get(x, 1) > 1]) == 1
                    else 0.4), (job, a, r[job]["fraction"])
            else:
                assert r[job]["fraction"][a] == 0.0


def test_fsdp4_cuts_per_rank_param_bytes_below_half(run):
    ranks, _, inits = run
    whole = sum(v.numel() * v.element_size() for v in inits["gpt2"].values())
    for r in ranks:
        assert r["fsdp4"]["bytes"] < whole / 2, (r["fsdp4"]["bytes"], whole)
        # Adam's two moments follow the params' blocks.
        assert r["fsdp4"]["opt_bytes"] == 2 * r["fsdp4"]["bytes"]


def test_zero1_shards_the_blocks_moments_over_dp(run):
    """Under dp2 x tp2 with ZeRO-1 each rank keeps half its tp blocks'
    moments (plus the padding to dp x 4 elements a group)."""
    ranks, _, _ = run
    for r in ranks:
        job = r["dp2_tp2_zero1"]
        assert 0 <= job["opt_bytes"] - job["bytes"] < 2 * 2 * 8 * 4


def test_a_block_is_gathered_again_in_its_backward(run):
    """The tiny GPT-2 at fsdp=4: each forward gathers wte, wpe and each
    block's 8 embed-cut leaves (query/key/value, out and its bias, fc_in,
    fc_out and its bias); none of a block's gathered leaves outlives the
    forward, and the backward gathers each block's 6 kernels again (the
    biases are added, not saved)."""
    ranks, _, _ = run
    for r in ranks:
        forward, both, (alive, blocks) = r["gathers"]
        assert forward == {"forward": 2 + 2 * 8, "backward": 0}
        assert both == {"forward": 2 + 2 * 8, "backward": 2 * 6}
        assert (alive, blocks) == (0, 2 * 8)


def _worker8(rank, world, port, tmp, inits):
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import build_mesh

    ts.join_world(rank, world, port)
    mesh = build_mesh(MeshConfig(dp=2, fsdp=2, tp=2))
    r = ts.port_run("gpt2", mesh, torch.load(inits)["gpt2"], zero1=True)
    torch.save({k: r[k] for k in ("losses", "params", "fraction")},
               f"{tmp}/rank{rank}.pt")


def test_dp2_tp2_fsdp2_zero1_on_8_ranks(run, tmp_path):
    """JAX's composed case whole: the batch over dp x fsdp, the leaves over
    fsdp and tp at once, the moments over dp."""
    _, ref, inits = run
    torch.save(inits, tmp_path / "inits.pt")
    ranks, _ = ts.spawn(_worker8, 8, tmp_path, str(tmp_path / "inits.pt"))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["gpt2"]["losses"],
                                   rtol=ts.RTOL, atol=ts.ATOL)
        assert r["losses"] == ranks[0]["losses"]
        assert r["fraction"]["tp"] > 0.4 and r["fraction"]["fsdp"] > 0.4
    ts.assert_params_close(ranks[0]["params"], ref["gpt2"]["params"])
