"""The image input path of the port against the JAX package's, bit for bit:
``SyntheticImages``, ``augment_bits`` and ``augment_images``, the C++
loader's ``native_image`` and ``record_file_image`` (on a file the test
writes, with and without augmentation, in both payload layouts), and the
port's copy of ``loader.cc`` byte for byte. The three ResNet configs diff
clean against the JAX configs."""

import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

from distributeddeeplearning_tpu_torch import config, data
from distributeddeeplearning_tpu_torch.native import loader

jax_data = importlib.import_module("distributeddeeplearning_tpu.data")
jax_loader = importlib.import_module(
    "distributeddeeplearning_tpu.native.loader")
jax_config = importlib.import_module("distributeddeeplearning_tpu.config")

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n_distinct", [0, 3])
def test_synthetic_images_are_jax_s(n_distinct):
    kw = dict(batch_size=6, image_size=9, channels=3, num_classes=7, seed=5,
              n_distinct=n_distinct)
    ours, theirs = data.SyntheticImages(**kw), jax_data.SyntheticImages(**kw)
    for i in (0, 1, 4):
        _equal(ours.batch(i), theirs.batch(i))


@pytest.mark.parametrize("seed,base,pad", [(0, 0, 4), (7, 123456, 2),
                                           (2**63 + 5, 2**40, 16)])
def test_augmentation_is_jax_s(seed, base, pad):
    for a, b in zip(data.augment_bits(seed, base, 32, pad),
                    jax_data.augment_bits(seed, base, 32, pad)):
        assert np.array_equal(a, b)
    images = data.SyntheticImages(8, 12, n_distinct=1).batch(0)["image"]
    ours = data.augment_images(images, seed=seed, base_index=base, pad=pad)
    assert np.array_equal(ours, jax_data.augment_images(
        images, seed=seed, base_index=base, pad=pad))
    assert not np.array_equal(ours, images)


def test_loader_source_is_the_jax_package_s():
    ours = (ROOT / "distributeddeeplearning_tpu_torch" / "native" /
            "loader.cc").read_bytes()
    theirs = (ROOT / "distributeddeeplearning_tpu" / "native" /
              "loader.cc").read_bytes()
    assert ours == theirs


def test_loader_builds_into_the_port_s_build_dir():
    path = loader.build()
    assert pathlib.Path(path).parent == pathlib.Path(loader.BUILD_DIR)
    assert pathlib.Path(loader.BUILD_DIR).name == "_build"
    assert loader.splitmix64(12345) == jax_loader._splitmix64(12345)


def test_native_images_are_jax_s():
    kw = dict(batch_size=5, image_size=6, channels=3, num_classes=11, seed=9)
    ours = data.make_dataset("native_image", **kw)
    theirs = jax_loader.NativeSyntheticImages(**kw)
    if theirs._h is None:
        pytest.fail("the JAX package's native loader did not build: its "
                    "numpy fallback draws other values")
    for i in (0, 3):
        _equal(ours.batch(i), theirs.batch(i))
    it = ours.iter_from(2)
    _equal(next(it), theirs.batch(2))
    _equal(next(it), theirs.batch(3))


def _write_records(path, n, size, channels=3, label_bytes=1, seed=0):
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, 256, (n, label_bytes + size * size * channels),
                        dtype=np.uint8)
    recs.tofile(path)


@pytest.mark.parametrize("augment,layout", [
    (False, "chw"), (True, "chw"), (True, "hwc")])
def test_record_file_images_are_jax_s(tmp_path, augment, layout):
    path = str(tmp_path / "train.bin")
    _write_records(path, n=37, size=8, label_bytes=2)
    kw = dict(path=path, batch_size=6, image_size=8, label_bytes=2,
              layout=layout, seed=3, augment=augment, aug_pad=2)
    ours = data.make_dataset("record_file_image", **kw)
    theirs = jax_loader.RecordFileImages(**kw)
    assert theirs._h is not None
    assert ours.num_records == 37
    for i in (0, 6, 7):  # batch 6 crosses into the second epoch
        _equal(ours.batch(i), theirs.batch(i))
    it = ours.iter_from(5)
    _equal(next(it), theirs.batch(5))


def test_native_build_failure_raises(monkeypatch):
    """No numpy fallback: a loader that cannot be built raises, naming the
    compiler."""
    monkeypatch.setattr(loader, "_LIB", [])
    monkeypatch.setattr(loader, "library_path", lambda: "/nonexistent/x.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native loader build failed"):
        data.make_dataset("native_image", batch_size=2)


def test_dataset_kwargs_follow_the_kinds():
    cfg = config.DataConfig(kind="record_file_image", path="x.bin",
                            augment=True)
    kw = cfg.dataset_kwargs()
    assert kw["path"] == "x.bin" and kw["augment"]
    assert cfg.eval_dataset_kwargs()["augment"] is False
    assert set(config.DataConfig(kind="native_image").dataset_kwargs()) == {
        "batch_size", "image_size", "channels", "num_classes", "seed",
        "num_threads", "prefetch_depth"}


@pytest.mark.parametrize("name", ["resnet18_cifar10", "resnet50_imagenet",
                                  "resnet50_imagenet_file"])
def test_configs_are_the_jax_package_s(name):
    ours = config.load_config(
        str(ROOT / "distributeddeeplearning_tpu_torch" / "configs" /
            f"{name}.py"))
    theirs = jax_config.load_config(str(ROOT / "configs" / f"{name}.py"))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
