"""The port's replica router (``serving/router.py``) against the JAX
package's, in-process, on the same tiny GPT-2 weights and traces under one
injected clock (``tests/torch_fleet.py``). Each scenario runs once per
module on each side (``_run``), and the two runs must agree:

- the three dispatch policies (``round_robin``, ``least_loaded``,
  ``prefix_affinity`` with its starvation guard): routes, greedy tokens
  (also equal to one engine's), the event stream, ``stats()`` (shed,
  rerouted, retried, per replica) and ``num_compiles`` — JAX's count of
  programs, lazily and after ``warmup``, never a constant;
- ``deadline`` shedding, which never takes a prefill or a queue slot;
- drain: intake cut, accepted work finished with the same tokens;
- quarantine on a step fault: queued requests rerouted, in-flight ones
  failed (``request_retry`` off) or retried token for token (on);
- the role split in-process: a prefill replica handing every request to
  two decode replicas, tokens and handoff ledgers equal to JAX's.

The router probes every replica with ``chain_digests`` hashed once; the
probe equals the trie's own match (``prefix_match_len``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_fleet import cell_clock, share_jax_programs, sides, submit_all
from torch_fleet import tokens as tokens_of
from torch_serving import prompts

torch.set_num_threads(2)

_MAX_NEW = 9
_TRACE = prompts((5, 9, 3, 12, 7, 4))
# Stats of a replica's engine that both packages report.
_ENGINE_KEYS = ("pending", "active", "finished", "dropped", "free_blocks",
                "used_blocks", "num_blocks", "block_bytes", "pages_per_seq",
                "prompt_buckets", "suffix_buckets", "num_compiles", "calls",
                "steps", "kv_quant", "draining", "prefix_cache", "handoff")


def _families():
    """Two prompt families (an 8-token prefix each, 2 blocks of 4) with
    distinct suffixes."""
    rng = np.random.default_rng(5)
    heads = [list(map(int, rng.integers(1, 97, 8))) for _ in range(2)]
    return [heads[i % 2] + list(map(int, rng.integers(1, 97, 2 + i % 3)))
            for i in range(8)]


@pytest.fixture(scope="module")
def both():
    undo = share_jax_programs()
    yield sides()
    undo()


def _summary(router):
    st = router.stats()
    per = [{k: r[k] for k in _ENGINE_KEYS if k in r}
           for r in st.pop("per_replica")]
    return {
        "routes": dict(router.routes),
        "tokens": tokens_of(router.finished()),
        "events": [{k: v for k, v in e.items() if k != "error"}
                   for e in router.events],
        "stats": st,
        "per_replica": per,
        "num_compiles": router.num_compiles,
        "failed": sorted(int(s.request.request_id) for s in router.failed),
    }


def _drain_to_idle(router, t, dt=0.01, limit=2000):
    for _ in range(limit):
        t[0] += dt
        if not router.step():
            return
    raise AssertionError("router never idle")


def _policy(side, policy, warm, **extra):
    t, clock = cell_clock()
    if policy == "prefix_affinity":
        extra.update(prefix_cache=True, suffix_buckets=(4,))
    router = side.router(side.cfg(replicas=2, router_policy=policy,
                                  **extra), clock)
    if warm:
        router.warmup()
    trace = _families() if policy == "prefix_affinity" else _TRACE
    if policy == "prefix_affinity":
        # One request per family first; once their chains are published
        # the rest follow their family's replica.
        submit_all(router, side, trace[:2], _MAX_NEW)
        t[0] += 0.01
        router.step()
        submit_all(router, side, trace[2:], _MAX_NEW, start=2)
    else:
        submit_all(router, side, trace, _MAX_NEW)
    _drain_to_idle(router, t)
    out = _summary(router)
    out["quant"] = [{"quant": r.engine.quant_report is not None}
                    for r in router.replicas]
    if policy == "prefix_affinity":
        # The router's pre-hashed probe equals each trie's own match.
        out["probes"] = [
            [r.match_digests(side.serving.chain_digests(p, 4))
             for r in router.replicas] for p in trace]
        out["trie"] = [[r.engine.prefix_match_len(p) for r in
                        router.replicas] for p in trace]
    return out


def _guard(side):
    """Starvation guard: one warm family, then 8 requests of it — the
    affinity target takes them until its queue is a lane-batch deeper
    than the idlest replica's."""
    t, clock = cell_clock()
    router = side.router(side.cfg(replicas=2, router_policy="prefix_affinity",
                                  prefix_cache=True, suffix_buckets=(4,)),
                         clock)
    fam = [p for p in _families() if p[:8] == _families()[0][:8]]
    submit_all(router, side, fam[:1], _MAX_NEW)
    t[0] += 0.01
    router.step()
    more = [fam[i % len(fam)] + [7 + i] for i in range(8)]
    submit_all(router, side, more, _MAX_NEW, start=1)
    _drain_to_idle(router, t)
    return _summary(router)


def _shed(side):
    t, clock = cell_clock()
    router = side.router(side.cfg(replicas=2, shed_policy="deadline",
                                  slots=1), clock)
    submit_all(router, side, _TRACE[:4], _MAX_NEW)
    t[0] += 1.0  # the queue heads have waited 1 s: the live age gauge
    out = {"shed": []}
    for j, (rid, slack) in enumerate(((10, 0.5), (11, 5.0), (12, 0.2))):
        req = side.Request(prompt=list(_TRACE[4 + j % 2]),
                           max_new_tokens=_MAX_NEW, request_id=rid,
                           deadline_s=t[0] + slack)
        try:
            router.submit(req)
        except side.serving.RequestShed as exc:
            out["shed"].append(exc.record)
    _drain_to_idle(router, t)
    out.update(_summary(router))
    out["prefills"] = [r.engine.calls["prefill"] for r in router.replicas]
    return out


def _drain(side):
    t, clock = cell_clock()
    router = side.router(side.cfg(replicas=2), clock)
    submit_all(router, side, _TRACE[:4], _MAX_NEW)
    t[0] += 0.01
    router.step()
    router.drain(0)
    submit_all(router, side, _TRACE[4:], _MAX_NEW, start=4)
    with pytest.raises(RuntimeError, match="draining"):
        router.replicas[0].engine.submit(side.Request(
            prompt=[1, 2, 3], max_new_tokens=2, request_id=99))
    _drain_to_idle(router, t)
    out = _summary(router)
    eng = router.replicas[0].engine
    out["free_after_drain"] = eng.scheduler.pool.free_blocks
    out["empty_pool"] = eng.num_blocks - 1
    return out


def _quarantine(side, retry):
    t, clock = cell_clock()
    router = side.router(side.cfg(replicas=2, slots=2, request_retry=retry),
                         clock)
    eng = router.replicas[0].engine
    orig, n = eng.step, [0]

    def faulty():
        n[0] += 1
        if n[0] == 3:
            raise RuntimeError("injected step fault")
        return orig()

    eng.step = faulty  # replica 0 dies on its third step
    submit_all(router, side, _TRACE, _MAX_NEW)
    _drain_to_idle(router, t)
    out = _summary(router)
    out["errors"] = [q["error"] for q in out["stats"]["quarantined"]]
    return out


def _roles(side):
    t, clock = cell_clock()
    cfg = side.cfg(prefix_cache=True, suffix_buckets=(4,),
                   router_policy="prefix_affinity")
    replicas = [side.replica(i, side.engine(
        dataclasses.replace(cfg, role=role), clock))
        for i, role in enumerate(("prefill", "decode", "decode"))]
    router = side.transports_router(cfg, clock, replicas)
    trace = _families()[:6] + [_families()[0]]
    submit_all(router, side, trace, _MAX_NEW)
    _drain_to_idle(router, t)
    out = _summary(router)
    out["handoff"] = [r.engine.stats()["handoff"] for r in router.replicas]
    return out


def _one_engine(side, trace, **kw):
    t, clock = cell_clock()
    eng = side.engine(side.cfg(**kw), clock)
    for i, p in enumerate(trace):
        eng.submit(side.Request(prompt=list(p), max_new_tokens=_MAX_NEW,
                                request_id=i))
    return tokens_of(eng.run())


_SCENARIOS = {
    "round_robin": lambda s: _policy(s, "round_robin", warm=False),
    "least_loaded": lambda s: _policy(s, "least_loaded", warm=False),
    "least_loaded_warm": lambda s: _policy(s, "least_loaded", warm=True),
    "int8_weights": lambda s: _policy(s, "least_loaded", warm=False,
                                      quant="int8"),
    "prefix_affinity": lambda s: _policy(s, "prefix_affinity", warm=True),
    "guard": _guard,
    "shed": _shed,
    "drain": _drain,
    "quarantine": lambda s: _quarantine(s, retry=False),
    "quarantine_retry": lambda s: _quarantine(s, retry=True),
    "roles": _roles,
    "one_engine": lambda s: _one_engine(s, _TRACE),
    "one_engine_families": lambda s: _one_engine(s, _families()),
}
_CACHE = {}


def _run(both, name):
    """Scenario ``name`` on each side, once per module."""
    if name not in _CACHE:
        _CACHE[name] = tuple(_SCENARIOS[name](side) for side in both)
    return _CACHE[name]


@pytest.mark.parametrize("name", ["round_robin", "least_loaded",
                                  "least_loaded_warm", "int8_weights",
                                  "prefix_affinity", "guard", "shed", "drain",
                                  "quarantine", "quarantine_retry", "roles"])
def test_router_matches_jax(both, name):
    jx, pt = _run(both, name)
    assert pt["routes"] == jx["routes"]
    assert pt["tokens"] == jx["tokens"]
    assert pt["events"] == jx["events"]
    assert pt["stats"] == jx["stats"]
    assert pt["per_replica"] == jx["per_replica"]
    assert pt["num_compiles"] == jx["num_compiles"]
    assert pt["failed"] == jx["failed"]


@pytest.mark.parametrize("name", ["round_robin", "least_loaded",
                                  "least_loaded_warm", "drain",
                                  "quarantine_retry", "shed"])
def test_tokens_equal_one_engine(both, name):
    _, pt = _run(both, name)
    _, one = _run(both, "one_engine")
    if name == "shed":  # request 11 carries the trace's prompt 5
        one = {**{k: one[k] for k in range(4)}, 11: one[5]}
    assert pt["tokens"] == one


@pytest.mark.parametrize("name", ["prefix_affinity", "roles"])
def test_prefix_paths_equal_one_engine(both, name):
    _, pt = _run(both, name)
    _, one = _run(both, "one_engine_families")
    # The roles trace repeats prompt 0 as request 6 (a full-prefix hit).
    alias = {6: 0} if name == "roles" else {}
    assert pt["tokens"] == {k: one[alias.get(k, k)] for k in pt["tokens"]}


def test_int8_weights_quantize_each_replica_once(both):
    _, pt = _run(both, "int8_weights")
    _, plain = _run(both, "least_loaded")
    assert pt["routes"] == plain["routes"] and len(pt["tokens"]) == 6
    assert all(r["quant"] for r in pt["quant"])
    assert not any(r["quant"] for r in plain["quant"])


def test_num_compiles_is_jax_count_not_a_constant(both):
    lazy = _run(both, "least_loaded")[1]
    warm = _run(both, "least_loaded_warm")[1]
    # Lazily: each replica readies decode plus the prefill widths its
    # requests needed; warm: every width on both replicas, and serving
    # added none.
    assert 2 <= lazy["num_compiles"] < warm["num_compiles"]
    assert warm["num_compiles"] == 2 * (len((8, 16)) + 1)
    assert _run(both, "prefix_affinity")[1]["num_compiles"] == 2 * (2 + 1 + 1)


def test_prefix_affinity_keeps_families_and_probes_match_the_trie(both):
    _, pt = _run(both, "prefix_affinity")
    assert [pt["routes"][i] for i in range(8)] == [0, 1] * 4
    assert pt["probes"] == pt["trie"]
    assert any(any(row) for row in pt["probes"])


def test_starvation_guard_spills_to_the_idle_replica(both):
    _, pt = _run(both, "guard")
    routes = [pt["routes"][i] for i in range(9)]
    assert routes[:4] == [0] * 4 and 1 in routes[4:]


def test_deadline_shedding_never_takes_a_prefill(both):
    jx, pt = _run(both, "shed")
    assert pt["shed"] == jx["shed"]
    assert [r["request_id"] for r in pt["shed"]] == [10, 12]
    assert all(r["reason"] == "deadline_infeasible" for r in pt["shed"])
    assert sorted(pt["tokens"]) == [0, 1, 2, 3, 11]
    # Five admitted requests, five prefills: the shed ones took none.
    assert sum(pt["prefills"]) == 5 == sum(jx["prefills"])
    assert pt["stats"]["shed"] == 2


def test_drain_finishes_accepted_work_and_empties_the_pool(both):
    _, pt = _run(both, "drain")
    assert pt["stats"]["draining"] == [0]
    assert all(pt["routes"][i] == 1 for i in (4, 5))
    assert pt["free_after_drain"] == pt["empty_pool"]
    assert pt["per_replica"][0]["draining"] is True


@pytest.mark.parametrize("retry", [False, True])
def test_quarantine_reroutes_queued_and_fails_or_retries_inflight(both,
                                                                  retry):
    jx, pt = _run(both, "quarantine_retry" if retry else "quarantine")
    assert pt["errors"] == jx["errors"] == [
        "RuntimeError: injected step fault"]
    st = pt["stats"]
    assert st["rerouted"] >= 1
    if retry:
        assert st["retried"] >= 1 and not pt["failed"]
        assert len(pt["tokens"]) == len(_TRACE)
    else:
        assert st["retried"] == 0 and pt["failed"]
        assert len(pt["tokens"]) + len(pt["failed"]) == len(_TRACE)


def test_roles_hand_off_to_decode_replicas_with_jax_ledgers(both):
    jx, pt = _run(both, "roles")
    assert pt["handoff"] == jx["handoff"]
    assert pt["stats"]["roles"] == ["prefill", "decode", "decode"]
    assert pt["stats"]["handoffs"] == 7
    assert all(pt["routes"][i] in (1, 2) for i in range(7))
    assert pt["handoff"][0]["exported"] == 7
