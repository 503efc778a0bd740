"""The port's training fault tolerance against the JAX package's
(``tests/test_fault_tolerance.py``, ``tests/test_fused_steps.py``,
``tests/test_serving.py``'s out-of-bounds tripwire):

- ``parse_fault_injection`` and the fusion fence with ``fault=``: JAX's
  verdicts and messages;
- the loop's event records (``fault_kill``, ``fault_hang``,
  ``fault_corrupt``, ``preempt_save``) equal JAX's ``metrics.event_record``
  for the same arguments; ``cli train``'s ``fault_disarmed`` and
  ``preempted_exit`` lines and exit codes equal JAX's ``cmd_train``'s;
- ``cli train`` with ``step:5`` exits 17, and a relaunch resumes and ends
  with params bit-equal to an undisturbed run's;
- a SIGTERM to a ``cli train`` process saves at that step, exits 21, and a
  relaunch resumes from exactly it;
- ``train.debug_nans`` raises ``FloatingPointError`` at the poisoned step,
  and a clean run is bit-identical with the flag on and off;
- ``train.debug_checks``: the paged attention's tripwire poisons the same
  rows as JAX's under ``jax_enable_checks`` and leaves the other rows as
  JAX's are.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import cli, data, debug, train
from distributeddeeplearning_tpu_torch.checkpoint import CheckpointManager
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)
from distributeddeeplearning_tpu_torch.models.transformer import (
    paged_decode_attention,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
TINY = [
    "model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
    "model.kwargs.max_len=64", "model.kwargs.dtype=float32",
    "data.vocab_size=256", "data.seq_len=32", "data.batch_size=4",
    "optim.warmup_steps=0", "train.log_every=1",
]
# One thread a child: the bit-equality checks compare fp32 runs of
# separate processes.
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
for _k in ("DDL_SUPERVISOR_ATTEMPT", "DDL_HEARTBEAT_FILE"):
    ENV.pop(_k, None)


def _argv(cmd, *overrides):
    argv = [cmd, "--config", CONFIG, "--device", "cpu"]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    return argv


def _train_proc(*overrides, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
         *_argv("train", *overrides)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=ENV, **kw)


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _saved_params(ckpt_dir, step):
    host = torch.load(os.path.join(ckpt_dir, str(step), "state.pt"),
                      map_location="cpu", weights_only=True)
    return host["params"]


# ---------------------------------------------------------------------------
# the parser and the fusion fence
# ---------------------------------------------------------------------------


FENCE_CASES = [
    ("", 1), ("step:5", 1), ("nan:3", 1), ("hang:7", 1), ("corrupt:6", 1),
    ("epoch:2", 1), ("nan:x", 1), ("step:4", 2), ("step:5", 2),
    ("nan:3", 2), ("hang:3", 2), ("corrupt:6", 2), ("bogus:3", 1),
]


@pytest.mark.parametrize("spec,k", FENCE_CASES)
def test_fault_parser_and_fusion_fence_follow_the_reference(spec, k):
    """The verdict and message of parsing ``spec`` and fencing it at
    ``steps_per_call=k`` (steps 8, save every 2) equal JAX's; a kind the
    parser refuses reaches the fence as a raw ``FaultSpec``."""
    from distributeddeeplearning_tpu import train as jax_train

    def verdict(mod):
        try:
            fault = mod.parse_fault_injection(spec)
        except ValueError as e:
            fault = mod.FaultSpec(*spec.split(":")) if spec.startswith(
                "bogus") else None
            if fault is None:
                return ("parse", str(e))
        if fault is not None:
            fault = mod.FaultSpec(fault.kind, int(fault.step))
        try:
            mod.check_fusion_cadences(k, steps=8, save_every=2, fault=fault)
        except ValueError as e:
            return ("fence", str(e))
        return ("ok", tuple(fault) if fault else None)

    assert verdict(train) == verdict(jax_train)


# ---------------------------------------------------------------------------
# the event records
# ---------------------------------------------------------------------------


class _Exit(Exception):
    pass


def _fit_records(tmp_path, monkeypatch, fault=None, sigterm_at=None):
    """The records the port's ``fit`` emits on the tiny GPT-2 over 8 steps
    (a save every 2), with ``os._exit`` and the hang's sleep turned into
    an exception, and a SIGTERM sent to this process when batch
    ``sigterm_at`` is drawn."""
    def fake_exit(code):
        raise _Exit(code)

    def fake_sleep(s):
        raise _Exit("hang")

    monkeypatch.setattr(os, "_exit", fake_exit)
    monkeypatch.setattr(train.time, "sleep", fake_sleep)
    cfg = apply_overrides(load_config(CONFIG), TINY + ["train.steps=8"])
    _, trainer, dataset = cli.build_all(cfg, "cpu")
    state = trainer.init(cfg.train.seed)

    def batches():
        for i, b in enumerate(dataset.iter_from(0)):
            if i == sigterm_at:
                # fit's handler is installed from the main thread only.
                assert threading.current_thread() is threading.main_thread()
                os.kill(os.getpid(), signal.SIGTERM)
            yield data.to_device(b, "cpu")

    records = []
    with CheckpointManager(str(tmp_path / "ck")) as ckpt:
        with contextlib.suppress(_Exit, train.Preempted):
            train.fit(trainer, state, batches(), steps=8, log_every=1,
                      log_fn=records.append, ckpt=ckpt, save_every=2,
                      fault=fault, heartbeat_file=str(tmp_path / "hb"))
        ckpt.wait()
        latest = ckpt.latest_step()
    return [r for r in records if "event" in r], latest


@pytest.mark.parametrize("kind", ["fault_kill", "fault_hang",
                                  "fault_corrupt", "preempt_save"])
def test_loop_event_records_equal_the_references(kind, tmp_path,
                                                 monkeypatch):
    from distributeddeeplearning_tpu.metrics import event_record
    from distributeddeeplearning_tpu_torch.supervisor import read_heartbeat

    handler = signal.getsignal(signal.SIGTERM)
    if kind == "preempt_save":
        events, latest = _fit_records(tmp_path, monkeypatch, sigterm_at=3)
        # The handler ran after batch 3 was drawn: the save comes at the
        # next call edge, step 4, forced (off the cadence would be the
        # same).
        want = event_record("preempt_save", 4, saved=True,
                            signum=int(signal.SIGTERM))
        assert latest == 4
    else:
        spec = {"fault_kill": "step:5", "fault_hang": "hang:7",
                "fault_corrupt": "corrupt:6"}[kind]
        events, latest = _fit_records(
            tmp_path, monkeypatch, train.parse_fault_injection(spec))
        at = int(spec.split(":")[1])
        fields = {"corrupted_step": 6} if kind == "fault_corrupt" else {}
        want = event_record(kind, at, **fields)
        hb = read_heartbeat(str(tmp_path / "hb"))
        assert hb == {"step": at, "attempt": 0, "phase": "save" if at % 2
                      == 0 else "log"}
    assert events == [want]
    # The signal handler is restored on the way out.
    assert signal.getsignal(signal.SIGTERM) is handler


def _cmd_lines(mod_cli, cfg, monkeypatch, capsys, **patch):
    for name, fn in patch.items():
        monkeypatch.setattr(mod_cli, name, fn)
    capsys.readouterr()
    try:
        rc = mod_cli.cmd_train(cfg, **({} if mod_cli is not cli
                                       else {"device": "cpu"}))
    except ValueError as e:
        rc = f"ValueError: {e}"
    out = capsys.readouterr().out
    return rc, [json.loads(x) for x in out.splitlines()
                if x.startswith('{"event"')]


@pytest.mark.parametrize("kind", ["fault_disarmed", "preempted_exit"])
def test_cli_event_lines_equal_the_references(kind, monkeypatch, capsys):
    """``fault_disarmed`` (a restarted attempt: the fault is dropped, then
    the cadence fence refuses steps 3 at steps_per_call 2 in both) and
    ``preempted_exit`` (exit code 21) as JAX's ``cmd_train`` prints and
    returns them."""
    from distributeddeeplearning_tpu import cli as jax_cli
    from distributeddeeplearning_tpu import config as jax_config
    from distributeddeeplearning_tpu.train import Preempted as JaxPreempted

    jax_cfg_path = os.path.join(REPO, "configs", "gpt2_owt.py")
    if kind == "fault_disarmed":
        monkeypatch.setenv("DDL_SUPERVISOR_ATTEMPT", "1")
        over = ["train.fault_injection=step:3", "train.steps=3",
                "train.steps_per_call=2"]
        patch_jax = patch_port = {}
    else:
        monkeypatch.delenv("DDL_SUPERVISOR_ATTEMPT", raising=False)
        over = ["train.steps=8"]

        def jax_once(*a, **k):
            raise JaxPreempted(5, True)

        def port_once(*a, **k):
            raise train.Preempted(5, True)

        patch_jax = {"_train_once": jax_once}
        patch_port = {"_train_once": port_once}
    want = _cmd_lines(jax_cli, jax_config.apply_overrides(
        jax_config.load_config(jax_cfg_path), over), monkeypatch, capsys,
        **patch_jax)
    got = _cmd_lines(cli, apply_overrides(load_config(CONFIG), TINY + over),
                     monkeypatch, capsys, **patch_port)
    assert got == want
    assert [r["event"] for r in got[1]] == [kind]


# ---------------------------------------------------------------------------
# crash, preemption and resume through cli train
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The ``cli train`` processes, side by side: an undisturbed run to
    step 8 (a save every 2), the same with ``step:5`` then its relaunch,
    and a 2000-step run that gets a SIGTERM after its first record, then
    its relaunch to 2 steps past the preempted one."""
    tmp = tmp_path_factory.mktemp("cli_runs")
    every = ["train.steps=8", "train.save_every=2"]
    ck = f"train.checkpoint_dir={tmp}/ck"
    procs = {
        "straight": _train_proc(*every, f"train.checkpoint_dir={tmp}/a"),
        "crashed": _train_proc(*every, f"train.checkpoint_dir={tmp}/b",
                               "train.fault_injection=step:5"),
        "preempted": _train_proc("train.steps=2000", "train.save_every=500",
                                 ck),
    }
    out = {"tmp": tmp}
    try:
        for line in procs["preempted"].stdout:  # wait until it steps
            if '"loss"' in line:
                break
        procs["preempted"].send_signal(signal.SIGTERM)
        for name in ("crashed", "preempted"):
            out[name] = (*procs[name].communicate(timeout=300),
                         procs[name].returncode)
        procs["resumed"] = _train_proc(*every,
                                       f"train.checkpoint_dir={tmp}/b")
        saves = [r for r in _records(out["preempted"][0])
                 if r.get("event") == "preempt_save"]
        n = saves[0]["step"] if saves else 0
        out["latest"] = CheckpointManager(str(tmp / "ck")).latest_step()
        out["n"] = n
        procs["relaunched"] = _train_proc(f"train.steps={n + 2}", ck)
        for name in ("straight", "resumed", "relaunched"):
            out[name] = (*procs[name].communicate(timeout=300),
                         procs[name].returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_step_fault_exits_17_and_the_relaunch_resumes_bit_equal(cli_runs):
    out, err, rc = cli_runs["crashed"]
    assert rc == 17, err[-3000:]
    assert _records(out)[-1] == {"event": "fault_kill", "step": 5}
    rout, rerr, rc = cli_runs["resumed"]
    assert rc == 0, rerr[-3000:]
    assert "resumed from step 4" in rout
    assert [r["step"] for r in _records(rout)] == [5, 6, 7, 8]
    sout, serr, rc = cli_runs["straight"]
    assert rc == 0, serr[-3000:]
    want = {r["step"]: r["loss"] for r in _records(sout)}
    assert {r["step"]: r["loss"] for r in _records(rout)} == {
        s: want[s] for s in (5, 6, 7, 8)}
    a, b = (_saved_params(cli_runs["tmp"] / d, 8) for d in "ab")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sigterm_saves_exits_21_and_the_relaunch_resumes_there(cli_runs):
    rest, err, rc = cli_runs["preempted"]
    assert rc == 21, err[-3000:]
    recs = _records(rest)
    (ev,) = [r for r in recs if r.get("event") == "preempt_save"]
    assert ev["saved"] is True and ev["signum"] == int(signal.SIGTERM)
    n = ev["step"]
    assert 1 <= n and n % 500 != 0  # off the cadence: the forced save
    assert recs[-1] == {"event": "preempted_exit", "step": n, "saved": True}
    assert cli_runs["latest"] == n
    out, err, rc = cli_runs["relaunched"]
    assert rc == 0, err[-3000:]
    assert f"resumed from step {n}\n" in out
    assert [r["step"] for r in _records(out)] == [n + 1, n + 2]


# ---------------------------------------------------------------------------
# train.debug_nans and train.debug_checks
# ---------------------------------------------------------------------------


def _run_cli(*overrides):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(_argv("train", *overrides))
    return rc, _records(buf.getvalue())


def test_debug_nans_raises_at_the_poisoned_step(tmp_path):
    with pytest.raises(FloatingPointError,
                       match=r"invalid value \(nan\) encountered in "
                       r"aten\.\S+ \(at step 2\)"):
        _run_cli("train.steps=4", "train.debug_nans=true",
                 "train.fault_injection=nan:2")
    assert not debug.nans_on()  # the switch is off again


def test_debug_nans_clean_run_is_bit_identical_on_and_off(tmp_path):
    params = []
    for on in ("false", "true"):
        ck = tmp_path / on
        rc, recs = _run_cli("train.steps=3", "train.save_every=3",
                            f"train.debug_nans={on}",
                            f"train.checkpoint_dir={ck}")
        assert rc == 0 and len(recs) == 3
        params.append((recs, _saved_params(ck, 3)))
    (r0, p0), (r1, p1) = params
    assert [r["loss"] for r in r0] == [r["loss"] for r in r1]
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_debug_nans_checks_kernel_outputs_by_wrapper_name():
    """A kernel wrapper's check names the wrapper, under the switch only;
    the dispatch mode names a torch op, and passes a NaN literal."""
    out = torch.tensor([1.0, float("nan")])
    debug.check_nans("paged_decode", out)  # off: nothing
    with debug.nan_checks():
        with pytest.raises(FloatingPointError, match="in paged_decode$"):
            debug.check_nans("paged_decode", out)
        debug.check_nans("paged_decode", torch.ones(2))
        # A NaN literal (0-d) is no computed value; a computed NaN is.
        lit = torch.full((), float("nan"))
        with pytest.raises(FloatingPointError, match="aten.add.Tensor"):
            torch.ones(3) + lit


def _tripwire_case():
    rng = np.random.default_rng(5)
    B, H, D, nb, bs, pages = 4, 2, 8, 12, 4, 3
    q = rng.standard_normal((B, 1, H, D), np.float32)
    k = rng.standard_normal((B, 1, H, D), np.float32)
    v = rng.standard_normal((B, 1, H, D), np.float32)
    pool_k = rng.standard_normal((nb, bs, H, D), np.float32)
    pool_v = rng.standard_normal((nb, bs, H, D), np.float32)
    # Row 1 holds num_blocks past its cursor, row 3 a -1; rows 0 and 2
    # are clean. Every row owns its blocks.
    table = np.array([[1, 2, 3], [4, nb, 5], [6, 7, 0], [9, -1, 10]],
                     np.int32)
    lens = np.array([5, 2, 7, 1], np.int32)
    return dict(q=q, k=k, v=v, pool_k=pool_k, pool_v=pool_v, table=table,
                lens=lens, kv_pages=(nb, bs, pages))


def _jax_tripwire(c):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu.models.transformer import (
        paged_decode_attention as jax_paged,
    )

    class Attn(nn.Module):
        @nn.compact
        def __call__(self, q, k, v):
            return jax_paged(self, q, k, v, dtype=jnp.float32,
                             kv_pages=c["kv_pages"])

    m = Attn()
    cache = m.init(jax.random.PRNGKey(0), c["q"], c["k"], c["v"])["cache"]
    cache = {**cache, "pool_key": jnp.asarray(c["pool_k"]),
             "pool_value": jnp.asarray(c["pool_v"]),
             "page_table": jnp.asarray(c["table"]),
             "seq_lens": jnp.asarray(c["lens"])}
    before = jax.config.jax_enable_checks
    jax.config.update("jax_enable_checks", True)
    try:
        out, _ = m.apply({"cache": cache}, c["q"], c["k"], c["v"],
                         mutable=["cache"])
    finally:
        jax.config.update("jax_enable_checks", before)
    return np.asarray(out)


@pytest.mark.parametrize("kernel", ["reference", "pallas"])
def test_debug_checks_tripwire_poisons_the_reference_rows(kernel):
    c = _tripwire_case()
    want = _jax_tripwire(c)
    t = {n: torch.from_numpy(np.array(c[n])) for n in
         ("q", "k", "v", "pool_k", "pool_v", "table", "lens")}
    pools = {"pool_key": t["pool_k"], "pool_value": t["pool_v"]}
    with debug.bounds_checks(True):
        got = paged_decode_attention(
            t["q"], t["k"], t["v"], dtype=torch.float32, pools=pools,
            page_table=t["table"], seq_lens=t["lens"], kernel=kernel)
    got = got.numpy()
    bad = np.isnan(want).all(axis=(1, 2, 3))
    assert bad.tolist() == [False, True, False, True]
    assert np.isnan(got).all(axis=(1, 2, 3)).tolist() == bad.tolist()
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-5, atol=1e-6)
    # The bad rows wrote into the null block, nowhere else.
    for blk in (4, 5, 9, 10):
        assert torch.equal(pools["pool_key"][blk],
                           torch.from_numpy(c["pool_k"][blk]))


def test_debug_checks_off_leaves_the_attention_as_it_was():
    c = _tripwire_case()
    c["table"][1, 1] = 8
    c["table"][3, 1] = 11
    t = {n: torch.from_numpy(np.array(c[n])) for n in
         ("q", "k", "v", "pool_k", "pool_v", "table", "lens")}

    def run(on):
        pools = {"pool_key": t["pool_k"].clone(),
                 "pool_value": t["pool_v"].clone()}
        with debug.bounds_checks(on):
            return paged_decode_attention(
                t["q"], t["k"], t["v"], dtype=torch.float32, pools=pools,
                page_table=t["table"], seq_lens=t["lens"])

    assert torch.equal(run(False), run(True))
    assert not debug.checks_on()


def test_heartbeat_carries_the_loop_position(tmp_path, monkeypatch):
    """A clean fit leaves its last heartbeat at the last save."""
    from distributeddeeplearning_tpu_torch.supervisor import read_heartbeat

    events, latest = _fit_records(tmp_path, monkeypatch)
    assert events == [] and latest == 8
    assert read_heartbeat(str(tmp_path / "hb")) == {
        "step": 8, "attempt": 0, "phase": "save"}
