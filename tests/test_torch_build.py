"""The port's kernel build, on the CPU: which library a source maps to.

``ops/_build.py`` names each library by a hash of what went into it, so a
library built from other sources is never loaded. The sources include the
shared headers of ``csrc/`` (``tc_mma.cuh``), so a header's edit must give
every source a new library path. No ``nvcc`` is needed: only paths are
computed.
"""

import os
import shutil

import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import _build

torch.set_num_threads(2)

SOURCES = ("flash_attention", "ring_attention", "paged_attention",
           "fused_adamw")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return copy


def _targets():
    return {name: _build._target(name)[1] for name in SOURCES}


def test_the_shared_header_is_included_by_both_attention_sources(csrc):
    assert (csrc / "tc_mma.cuh").exists()
    for name in ("flash_attention", "ring_attention"):
        assert '#include "tc_mma.cuh"' in (csrc / f"{name}.cu").read_text()


@pytest.mark.parametrize("edited", ["tc_mma.cuh", "ring_attention.cu"])
def test_an_edit_changes_the_library_path(csrc, edited):
    before = _targets()
    assert before == _targets()  # the same files give the same paths
    with open(csrc / edited, "a") as f:
        f.write("\n// touched\n")
    after = _targets()
    if edited.endswith(".cuh"):  # every source hashes every header
        changed = set(SOURCES)
    else:
        changed = {edited[:-len(".cu")]}
    assert {n for n in SOURCES if before[n] != after[n]} == changed
    for name, path in after.items():
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert os.path.basename(path).startswith(f"lib{name}-")


def test_a_new_header_changes_every_library_path(csrc):
    before = _targets()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _targets()
    assert all(before[n] != after[n] for n in SOURCES)


def test_the_flags_are_hashed(csrc, monkeypatch):
    before = _targets()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert all(before[n] != p for n, p in _targets().items())
