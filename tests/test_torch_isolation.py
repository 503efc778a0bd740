"""The port stands alone: no module of ``distributeddeeplearning_tpu_torch``
and nothing in ``chip_smoke.py`` imports JAX, flax, optax or the JAX
package, so it runs on a GPU host that has none of them. Its entry points
run on the GPU unless asked, and ``cli train`` refuses by name every knob
whose feature is not ported yet."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "distributeddeeplearning_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distributeddeeplearning_tpu")


def _sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("torch_*.py")))
    return [p for p in files if "_build" not in p.parts]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    # Whole dotted names: distributeddeeplearning_tpu_torch shares the JAX
    # package's prefix but is not it.
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_sources_exist():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "engine.py", "paged_attention.py",
            "transformer.py", "gpt2.py", "cli.py", "flash_attention.py",
            "fused_adamw.py", "train.py", "data.py", "dataset_base.py",
            "precision.py", "chunked_xent.py", "mesh.py", "comms.py",
            "sp_ring.py", "ring_attention.py",
            "ring_attention_pallas.py", "checkpoint.py", "zero.py",
            "metrics.py", "weights.py", "resnet.py", "benchmark.py",
            "loader.py", "vit.py", "bert.py", "remat.py",
            "vit_imagenet21k.py", "bert_mlm.py", "llama.py", "hf_port.py",
            "llama_lm.py", "moe.py", "ep.py", "sow.py", "data_text.py",
            "prepare_data.py", "gpt2_moe.py", "llama_moe.py",
            "gpt2_owt_file.py", "generate.py", "health.py",
            "torch_launch_profile.py", "comms_quant.py", "comms_overlap.py",
            "comms_hier.py", "supervisor.py", "net.py", "router.py",
            "worker.py", "fleet_supervisor.py", "debug.py",
            "torch_chaos_run.py", "torch_serve_chaos.py"} <= names
    csrc = {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert {"paged_attention.cu", "flash_attention.cu",
            "fused_adamw.cu", "ring_attention.cu"} <= csrc


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_check_compares_whole_names():
    assert _forbidden("distributeddeeplearning_tpu.ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden("distributeddeeplearning_tpu_torch.ops")
    assert not _forbidden("jaxtyping_not_really")


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if "_build" not in p.parts and "configs" not in p.parts
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', "
        "'distributeddeeplearning_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from distributeddeeplearning_tpu_torch.config import load_config\n"
        "load_config('distributeddeeplearning_tpu_torch/configs/"
        "gpt2_owt.py')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


CONFIG = "distributeddeeplearning_tpu_torch/configs/gpt2_owt.py"
TINY = ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
        "model.kwargs.max_len=64", "data.vocab_size=256", "data.seq_len=64",
        "data.batch_size=2", "train.steps=1"]


def _train(*overrides, device="cpu"):
    from distributeddeeplearning_tpu_torch import cli

    argv = ["train", "--config", str(ROOT / CONFIG)]
    if device is not None:
        argv += ["--device", device]
    for o in TINY + list(overrides):
        argv += ["--override", o]
    return cli.main(argv)


def test_cli_train_default_device_is_the_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _train(device=None)


def _generate(config, *overrides, device="cpu"):
    from distributeddeeplearning_tpu_torch import cli

    argv = ["generate", "--config", str(ROOT / config), "--prompt", "hi",
            "--max-new-tokens", "2"]
    if device is not None:
        argv += ["--device", device]
    for o in overrides:
        argv += ["--override", o]
    return cli.main(argv)


def test_cli_generate_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _generate(CONFIG, *TINY, device=None)


def test_cli_generate_refuses_gpt2_moe_by_name():
    """The reference's gpt2_moe has no KV-cache decode, and cli generate
    refuses it with the reference's words."""
    with pytest.raises(ValueError, match="'gpt2_moe' has no KV-cache decode "
                       "support"):
        _generate("distributeddeeplearning_tpu_torch/configs/gpt2_moe.py",
                  "model.kwargs.size=tiny", "model.kwargs.vocab_size=256")


@pytest.mark.parametrize("override,knob", [
    ("train.fault_injection=step:3", "train.fault_injection"),
    ("telemetry.enabled=True", "telemetry.enabled"),
    ("train.fault_injection=hang:3", "train.fault_injection"),
    ("train.fault_injection=corrupt:3", "train.fault_injection"),
    ("train.grad_comm=int8", "train.grad_comm"),
    ("train.grad_bucket_mb=4.0", "train.grad_bucket_mb"),
    ("train.update_sharding=sharded", "train.update_sharding"),
    ("train.comm_hierarchy=hierarchical", "train.comm_hierarchy"),
    ("train.sequence_parallel=True", "train.sequence_parallel"),
    ("train.debug_nans=True", "train.debug_nans"),
    ("mesh.tp=2", "mesh"),
])
def test_unported_train_knobs_are_refused_by_name(override, knob):
    if knob in SYNC_KNOBS:
        # The explicit dp sync is ported (tests/test_torch_grad_comm.py,
        # tests/test_torch_multislice.py): over 4 ranks the knob passes the
        # fences (the sharded update with the optimizer its fences allow,
        # the hierarchy over 2 slices), and where the reference refuses
        # it, it is refused with the reference's type and knob.
        _accepted(override, *SYNC_KNOBS[knob], world=4)
        with pytest.raises(NotImplementedError, match=rf"{knob[6:]}=.* is "
                           "pure-DP in v1"):
            _accepted(override, *SYNC_KNOBS[knob], "mesh.dp=4",
                      "mesh.cp=2", "model.kwargs.attn_impl=ring", world=8)
        return
    if knob in ("train.fault_injection", "telemetry.enabled",
                "train.debug_nans"):
        # Ported with cli supervise (tests/test_torch_fault_tolerance.py,
        # tests/test_torch_supervise.py): the composition is accepted.
        _accepted(override, world=1)
        return
    model = {"train.sequence_parallel": "vit", "mesh": "resnet50"}.get(knob)
    extra = [f"model.name={model}"] if model else []
    if model:
        # Every model of the zoo runs tp and sequence parallelism now
        # (tests/test_torch_encoders_tp.py): the composition is accepted.
        _accepted(override, *extra, world=4)
        return
    with pytest.raises(NotImplementedError,
                       match=rf"^{knob}=.*ROADMAP queue A\d+"):
        _train(override, *extra)


# The explicit dp sync's knobs -> what the reference's fences need beside
# them to accept the knob.
SYNC_KNOBS = {
    "train.grad_comm": [], "train.grad_bucket_mb": [],
    "train.update_sharding": ["optim.name=adamw", "optim.weight_decay=0.0",
                              "optim.grad_clip=0.0"],
    "train.comm_hierarchy": ["mesh.dcn_dp=2"],
}


def _accepted(*overrides, world):
    """``cli``'s composition fences pass over a job of ``world`` ranks."""
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    cfg = apply_overrides(load_config(str(ROOT / CONFIG)),
                          TINY + list(overrides))
    cli.check_train_composition(cfg, world_size=world)


@pytest.mark.parametrize("override,knob", [
    ("train.checkpoint_dir={tmp}/ckpt", "train.checkpoint_dir"),
    ("train.save_every=10", "train.save_every"),
    ("train.eval_every=10", "train.eval_every"),
    ("train.grad_accum=2", "train.grad_accum"),
    ("train.steps_per_call=2", "train.steps_per_call"),
    ("mesh.dp=2", "mesh"),
    ("train.log_dir={tmp}/logs", "train.log_dir"),
    ("train.remat=full", "train.remat"),
    ("train.remat=dots", "train.remat"),
])
def test_ported_train_knobs_run(override, knob, tmp_path):
    """The knobs of ZeRO-1, accumulation, checkpoints, evaluation, the
    metrics writer and remat run on the CPU at tiny width. ``mesh.dp=2`` in one
    process is a mesh that needs 2 ranks: ``build_mesh`` names the world
    size."""
    override = override.format(tmp=tmp_path)
    assert override.startswith(knob)
    extra = ["train.steps=2"] if knob == "train.steps_per_call" else []
    if knob == "mesh":
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            _train(override, *extra)
        return
    assert _train(override, *extra, "model.kwargs.dtype=float32") == 0
    if knob == "train.checkpoint_dir":
        assert os.listdir(tmp_path / "ckpt") == []  # save_every=0
    if knob == "train.log_dir":
        assert (tmp_path / "logs" / "metrics.jsonl").exists()


@pytest.mark.parametrize("override,exc,match", [
    ("model.kwargs.attn_impl=ulysses", NotImplementedError,
     "attn_impl='ulysses'"),
    ("train.precision.policy=bf16_full", ValueError, "bf16_full"),
    ("data.kind=grain_token_file_lm", NotImplementedError,
     "grain_token_file_lm"),
    ("model.kwargs.attn_impl=ring", NotImplementedError, "attn_impl='ring'"),
])
def test_unported_paths_are_refused_by_name(override, exc, match):
    if override in HELD_PATHS:
        # Held since Ulysses and a ring over one rank were ported
        # (``tests/test_torch_ulysses.py``): on one rank the core alone.
        assert _train(override, "model.kwargs.dtype=float32") == 0
        return
    with pytest.raises(exc, match=match):
        _train(override)


# The paths of the parametrization above that now train.
HELD_PATHS = ("model.kwargs.attn_impl=ulysses", "model.kwargs.attn_impl=ring")


def test_zero1_on_one_device_is_accepted(capsys):
    """gpt2_owt sets train.zero1=True: over dp=1 it is a no-op placement."""
    assert _train("train.zero1=True", "model.kwargs.dtype=float32") == 0
    assert '"step": 1' not in capsys.readouterr().out  # log_every=20


@pytest.mark.parametrize("override,axis", [
    ("mesh.fsdp=2", "fsdp"), ("mesh.ep=2", "ep"),
    ("mesh.dcn_dp=2", "dcn_dp"), ("mesh.tp=4", "tp"),
])
def test_unported_mesh_axes_are_refused_by_name(override, axis):
    # GPT-2 and Llama run fsdp and tp; the other models refuse them. ep is
    # ported for the MoE models: over plain GPT-2 it is the reference's
    # ValueError, an axis no component consumes.
    if axis == "ep":
        with pytest.raises(ValueError, match=r"^mesh ep=2 but model "
                           r"'gpt2' has no experts"):
            _train(override, "mesh.dp=1")
        return
    if axis == "dcn_dp":
        # Data parallelism across slices is ported
        # (tests/test_torch_multislice.py): over 4 ranks in 2 slices the
        # hierarchical sync passes the fences; one rank, whose dp the 2
        # slices do not divide, is refused with the reference's words.
        _accepted(override, world=4)
        with pytest.raises(ValueError, match="dp=1 not divisible by "
                           "dcn_dp=2"):
            _train(override, "mesh.dp=1")
        return
    model = {"fsdp": "vit", "tp": "resnet50"}.get(axis)
    extra = [f"model.name={model}"] if model else []
    if model:
        # Every model of the zoo runs fsdp and tp now
        # (tests/test_torch_encoders_tp.py): the composition is accepted.
        _accepted(override, "mesh.dp=1", *extra, world=4)
        return
    with pytest.raises(NotImplementedError,
                       match=rf"^mesh=.*mesh\.{axis}=\d+ .*ROADMAP queue A13"):
        _train(override, "mesh.dp=1", *extra)


def test_zero1_over_dp_composes():
    """gpt2_owt sets train.zero1=True: over dp > 1 that is ZeRO-1 across
    ranks (``parallel/zero.py``), composed with cp too."""
    from distributeddeeplearning_tpu_torch import cli
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    cfg = apply_overrides(load_config(str(ROOT / CONFIG)), TINY)
    assert cfg.train.zero1
    cli.check_train_composition(cfg, world_size=4)
    cli.check_train_composition(
        apply_overrides(cfg, ["mesh.dp=2", "mesh.cp=2",
                              "model.kwargs.attn_impl=ring_pallas"]),
        world_size=4)


@pytest.mark.parametrize("impl", ["ulysses", "ulysses_flash"])
def test_ulysses_is_refused_by_name(impl):
    """Held since the Ulysses cores were ported
    (``tests/test_torch_ulysses.py``): the composition builds and its
    forward at the tiny size equals the plain core's (one rank: no
    flip)."""
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    outs = []
    for core in ("xla", impl):
        model = models.get_model("gpt2", size="tiny", vocab_size=64,
                                 max_len=32, attn_impl=core,
                                 mesh=Mesh({"cp": 1}))
        model.init_weights(torch.Generator().manual_seed(0))
        outs.append(model(tokens))
    assert outs[1].shape == (2, 16, 64)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_cp_needs_a_ring_core(impl):
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.train import (
        AdamW,
        Trainer,
        get_task,
    )

    mesh = Mesh({"cp": 2})
    model = models.get_model("gpt2", size="tiny", vocab_size=64, max_len=16,
                             attn_impl=impl, mesh=mesh)
    with pytest.raises(ValueError, match=r"mesh cp=2 but model GPT2 "
                       rf"attention \(attn_impl='{impl}'\) is not "
                       "context-parallel"):
        Trainer(model, AdamW(1e-3), get_task("lm", mesh=mesh), device="cpu",
                mesh=mesh)


def test_ring_needs_a_mesh():
    from distributeddeeplearning_tpu_torch import models

    with pytest.raises(ValueError, match="attn_impl='ring_pallas' requires "
                       "mesh"):
        models.get_model("gpt2", size="tiny", attn_impl="ring_pallas")


def test_mesh_that_does_not_fit_the_ranks_is_refused():
    """mesh.cp=2 in one process: the mesh needs 2 ranks."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _train("mesh.cp=2", "mesh.dp=1", "train.zero1=false",
               "model.kwargs.attn_impl=ring")
