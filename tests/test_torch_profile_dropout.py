"""``cli/profile_dropout.py``'s versions of the dropout kernel's source: the
copies it builds must carry the constants asked for (or the ceiling's
Philox), so that a change to ``csrc/dropout.cu`` that moves them fails here
rather than timing the wrong kernel on the card."""

import re

import pytest

from vln_bevbert_tpu_torch import _build
from vln_bevbert_tpu_torch.cli import profile_dropout


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    return tmp_path


def test_variant_sets_threads_and_unroll(build_dir):
    src = (profile_dropout.variant_csrc(64, 3) / "dropout.cu").read_text()
    assert re.findall(r"constexpr int (kThreads|kUnroll) = (\d+);", src) == [
        ("kThreads", "64"), ("kUnroll", "3")]
    original = (_build.CSRC / "dropout.cu").read_text()
    unset = r"constexpr int (kThreads|kUnroll) = \d+;"
    assert re.sub(unset, "", src) == re.sub(unset, "", original)


def test_ceiling_returns_ones_before_philox(build_dir):
    src = (profile_dropout.ceiling_csrc() / "dropout.cu").read_text()
    head = "uint4 philox(uint32_t g, uint32_t k0) {\n  return make_uint4(~0u, ~0u, ~0u, ~0u);\n"
    assert src.count(head) == 1
    assert src.replace("  return make_uint4(~0u, ~0u, ~0u, ~0u);\n", "", 1) == (
        _build.CSRC / "dropout.cu").read_text()
