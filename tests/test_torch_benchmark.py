"""``benchmark.run_benchmark`` and ``cli benchmark`` keep the record's
contract on the CPU (the device chosen explicitly), and ``cli train`` and
``cli eval`` run the classification configs and the two encoder configs
(ViT-L/16 and BERT-base MLM, cut to a tiny width); the MLM record counts
the batch's ``input_tokens``. The record's numbers from
the CPU are CPU numbers: ``platform`` says so, and the device-only fields
(``hbm_peak_bytes``, ``mfu``) are null or absent."""

import json
import math
import pathlib

import pytest
import torch

from distributeddeeplearning_tpu_torch import benchmark, cli
from distributeddeeplearning_tpu_torch.config import (
    apply_overrides,
    load_config,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "distributeddeeplearning_tpu_torch" / "configs"
TINY = {
    "resnet18_cifar10": ["model.kwargs.width=8", "data.batch_size=8",
                         "data.image_size=16"],
    "resnet50_imagenet": ["model.kwargs.width=4", "data.batch_size=4",
                          "data.image_size=32", "data.num_classes=10",
                          "model.kwargs.num_classes=10"],
}
# Tiny cuts of the encoder configs: remat 'full' as shipped (ViT), padded
# MLM rows with grad_accum 4 as shipped (BERT).
ENCODERS = {
    "vit_imagenet21k": ["model.kwargs.size=tiny", "model.kwargs.image_size=32",
                        "data.image_size=32", "model.kwargs.num_classes=10",
                        "data.num_classes=10", "data.batch_size=4"],
    "bert_mlm": ["model.kwargs.size=tiny", "model.kwargs.vocab_size=256",
                 "data.vocab_size=256", "data.seq_len=32",
                 "data.batch_size=8", "data.pad_min_len=8",
                 "train.head_chunk=16"],
}
KEYS = {"metric", "value", "unit", "steps_per_sec", "params",
        "device_count", "platform", "device_kind", "loss", "p50_step_ms",
        "p90_step_ms", "steps_per_call_probe", "fused_steps_per_sec",
        "dispatch_overhead_ms_per_step", "precision",
        "param_bytes_per_member", "opt_state_bytes_per_member",
        "hbm_peak_bytes", "model_tflops_per_step",
        "achieved_tflops_per_sec"}


def _cfg(name, *extra):
    return apply_overrides(load_config(str(CONFIGS / f"{name}.py")),
                           TINY[name] + list(extra))


def test_run_benchmark_record_contract():
    cfg = _cfg("resnet18_cifar10")
    rec = benchmark.run_benchmark(cfg, "cpu", warmup=1, steps=4,
                                  latency_steps=3, fused_probe=2)
    assert set(rec) == KEYS  # no mfu off the card
    assert rec["metric"] == "resnet18_classification_throughput"
    assert rec["unit"] == "images/sec/chip"
    assert rec["platform"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["device_count"] == 1 and rec["hbm_peak_bytes"] is None
    n = sum(p.numel() for p in cli.build_all(cfg, "cpu")[0].parameters())
    assert rec["params"] == n and rec["param_bytes_per_member"] == 4 * n
    assert rec["opt_state_bytes_per_member"] == 4 * n  # SGD's trace
    assert rec["value"] == pytest.approx(8 * rec["steps_per_sec"],
                                         rel=1e-3)
    assert rec["p50_step_ms"] <= rec["p90_step_ms"]
    assert rec["steps_per_call_probe"] == 2
    assert rec["model_tflops_per_step"] > 0 and rec["precision"] == "fp32"
    json.dumps(rec)


def test_flops_count_the_convolutions():
    """One step's counted FLOPs: forward + backward of ResNet-50's convs
    and head at width 4, 32², batch 4, about 3x the forward's."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _cfg("resnet50_imagenet")
    model, trainer, dataset = cli.build_all(cfg, "cpu")
    x = torch.from_numpy(dataset.batch(0)["image"])
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            model(x, train=False)
    rec = benchmark.run_benchmark(cfg, "cpu", warmup=0, steps=1,
                                  latency_steps=0, fused_probe=0)
    assert "steps_per_call_probe" not in rec
    step_flops = rec["model_tflops_per_step"] * 1e12
    assert 2.5 < step_flops / fwd.get_total_flops() < 3.5


def test_peak_table_needs_a_card():
    assert benchmark.peak_tflops("cpu") is None
    names = [k for k, _ in benchmark._PEAK_TFLOPS]
    # Specific parts before the family name they contain.
    assert names.index("H100 NVL") < names.index("H100")
    assert names.index("H100 PCIe") < names.index("H100")


def _main(cmd, name, *extra, device="cpu", flags=()):
    argv = [cmd, "--config", str(CONFIGS / f"{name}.py"), "--device", device]
    for o in {**TINY, **ENCODERS}[name] + list(extra):
        argv += ["--override", o]
    return cli.main(argv + list(flags))


def test_cli_benchmark_prints_the_record(capsys):
    assert _main("benchmark", "resnet50_imagenet") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["metric"] == "resnet50_classification_throughput"
    assert rec["precision"] == "fp32" and rec["platform"] == "cpu"


@pytest.mark.parametrize("probe", [2, 0])
def test_cli_benchmark_takes_its_depth(probe, capsys):
    assert _main("benchmark", "resnet18_cifar10", flags=(
        "--steps", "2", "--latency-steps", "1", "--probe", str(probe))) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps_per_sec"] > 0 and rec["p50_step_ms"] > 0
    assert rec.get("steps_per_call_probe") == (probe or None)


@pytest.mark.parametrize("name", sorted(TINY))
def test_cli_train_and_eval_run_the_classification_configs(name, capsys,
                                                           tmp_path):
    extra = ["train.steps=2", "train.log_every=1", "train.save_every=2",
             f"train.checkpoint_dir={tmp_path}", "train.eval_batches=1"]
    assert _main("train", name, *extra) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert set(recs[0]) == {"loss", "xent", "accuracy", "step", "wall_s"}
    assert _main("eval", name, *extra) == 0
    out = capsys.readouterr().out.splitlines()
    assert "evaluating checkpoint at step 2" in out
    rec = json.loads(out[-1])
    assert set(rec) == {"eval_loss", "eval_xent", "eval_accuracy", "step"}


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main("benchmark", "resnet18_cifar10", device=None)


def test_zero1_over_sgd_is_refused_before_the_build():
    cfg = _cfg("resnet18_cifar10", "train.zero1=True")
    cli.check_train_composition(cfg, world_size=1)  # dp=1: a no-op
    with pytest.raises(NotImplementedError,
                       match=r"^train.zero1=True: ZeRO-1 of the SGD .*A8"):
        cli.check_train_composition(cfg, world_size=2)


@pytest.mark.parametrize("name,unit,items", [
    ("bert_mlm", "tokens/sec/chip", 8 * 32),
    ("vit_imagenet21k", "images/sec/chip", 4)])
def test_cli_benchmark_on_the_encoder_configs(name, unit, items, capsys):
    assert _main("benchmark", name) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    model = name.split("_")[0]
    task = "mlm" if model == "bert" else "classification"
    assert rec["metric"] == f"{model}_{task}_throughput"
    assert rec["unit"] == unit and rec["platform"] == "cpu"
    assert rec["value"] == pytest.approx(items * rec["steps_per_sec"],
                                         rel=1e-3)
    assert rec["model_tflops_per_step"] > 0


@pytest.mark.parametrize("name,keys", [
    ("bert_mlm", {"loss", "masked_fraction"}),
    ("vit_imagenet21k", {"loss", "xent", "accuracy"})])
def test_cli_train_and_eval_run_the_encoder_configs(name, keys, capsys,
                                                    tmp_path):
    extra = ["train.steps=2", "train.log_every=1", "train.save_every=2",
             f"train.checkpoint_dir={tmp_path}", "train.eval_batches=1"]
    assert _main("train", name, *extra) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert set(recs[0]) == keys | {"step", "wall_s"}
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert _main("eval", name, *extra) == 0
    out = capsys.readouterr().out.splitlines()
    assert "evaluating checkpoint at step 2" in out
    assert set(json.loads(out[-1])) == {f"eval_{k}" for k in keys} | {
        "step"}
