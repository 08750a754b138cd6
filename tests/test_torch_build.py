"""cse_tpu_torch.ops._build without a compiler: every source and C entry is
declared, and the library's name follows the sources, so an edited source
(or a new one) is built anew instead of loading a stale library."""

import re
import shutil

import pytest

from cse_tpu_torch.ops import _build


def test_every_source_exists_and_every_entry_is_defined():
    text = ""
    for src in _build.SOURCES:
        assert (_build.CSRC / src).exists(), src
        text += (_build.CSRC / src).read_text()
    defined = set(re.findall(r"^int (cse_\w+)\(", text, flags=re.M))
    assert defined == set(_build.SIGNATURES)


@pytest.mark.parametrize("edit", ["change", "add"])
def test_library_name_follows_the_sources(tmp_path, monkeypatch, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert _build.library_path() == before  # stable while nothing changes
    if edit == "change":
        src = csrc / "attention.cu"
        src.write_text(src.read_text() + "\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent
