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


# every *_info entry point of the sources: the bf16 attention launchers' routes
ROUTE_ENTRIES = [("attention.cu", "cse_flash_fwd_info"), ("attention.cu", "cse_flash_bwd_info"),
                 ("kernel_parts.cu", "cse_kp_attention_info"), ("fused_stack.cu", "cse_attention_info"),
                 ("fused_train.cu", "cse_attention_bwd_info")]


# the LayerNorm launchers' *_info entry points: {entry: its Python reader's key list}
LN_INFO_ENTRIES = {("fused_train.cu", "cse_layer_norm_bwd_info"): "LN_BWD_INFO_KEYS",
                   ("kernel_parts.cu", "cse_kp_layer_norm_info"): "KP_LN_INFO_KEYS"}


# the w8a8 kernels' attributes: {entry: (its Python reader's key list, the kernels it names in order)}
W8A8_INFO_ENTRIES = {("fused_stack_w8a8.cu", "cse_w8a8_kernel_info"): ("KERNEL_INFO_KEYS",
                                                                       ("layer_norm_quant", "ffn_w8a8"))}


# the MLA prefill kernel's attributes: {entry: its Python reader's key list in ops/mla.py}
MLA_INFO_ENTRIES = {("mla.cu", "cse_mla_prefill_info"): "INFO_KEYS"}


def test_route_entries_are_every_info_entry():
    found = {(src, e) for src in _build.SOURCES for e in re.findall(r"^int (cse_\w+_info)\(",
                                                                    (_build.CSRC / src).read_text(), flags=re.M)}
    assert found == set(ROUTE_ENTRIES) | set(LN_INFO_ENTRIES) | set(W8A8_INFO_ENTRIES) | set(MLA_INFO_ENTRIES)


@pytest.mark.parametrize("src, entry", sorted(MLA_INFO_ENTRIES))
def test_mla_info_entry_matches_its_reader(src, entry, monkeypatch):
    """The MLA ``*_info`` entry writes as many ints as ``mla_attention_info``
    names, takes the widths the wrapper passes, and a failed query raises."""
    from cse_tpu_torch.ops import mla

    keys = getattr(mla, MLA_INFO_ENTRIES[(src, entry)])
    comment = re.search(rf"((?://[^\n]*\n)+)int {entry}\(", (_build.CSRC / src).read_text()).group(1)
    assert f"info[{len(keys)}]" in comment
    seen = []

    def fake(err):
        def call(dn, dr, dv, out):
            seen.append((dn, dr, dv))
            for i in range(len(keys)):
                out[i] = 10 + i
            return err
        return type("Lib", (), {entry: staticmethod(call)})()

    monkeypatch.setattr(_build, "library", lambda: fake(0))
    assert mla.mla_attention_info() == {k: 10 + i for i, k in enumerate(keys)}
    assert seen == [mla.WIDTHS[0]]
    monkeypatch.setattr(_build, "library", lambda: fake(1))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        mla.mla_attention_info(mla.WIDTHS[1])


@pytest.mark.parametrize("src, entry", sorted(W8A8_INFO_ENTRIES))
def test_w8a8_info_entry_matches_its_reader(src, entry, monkeypatch):
    """The w8a8 ``*_info`` entry writes as many ints as ``kernel_info`` names,
    takes its kernels in the order the source's comment gives, and a failed
    query raises."""
    from cse_tpu_torch.ops import fused_stack_w8a8 as w8

    keys_name, kernels = W8A8_INFO_ENTRIES[(src, entry)]
    keys = getattr(w8, keys_name)
    comment = re.search(rf"((?://[^\n]*\n)+)int {entry}\(", (_build.CSRC / src).read_text()).group(1)
    assert f"info[{len(keys)}]" in comment
    assert all(f"kernel {i}: {k}_kernel" in comment for i, k in enumerate(kernels))
    seen = []

    def fake(err):
        def call(kernel, out):
            seen.append(kernel)
            for i in range(len(keys)):
                out[i] = 10 + i
            return err
        return type("Lib", (), {entry: staticmethod(call)})()

    monkeypatch.setattr(_build, "library", lambda: fake(0))
    assert [w8.kernel_info(k) for k in kernels] == [{k: 10 + i for i, k in enumerate(keys)}] * len(kernels)
    assert seen == list(range(len(kernels)))
    monkeypatch.setattr(_build, "library", lambda: fake(2))
    with pytest.raises(RuntimeError, match="cudaError 2"):
        w8.kernel_info(kernels[0])


@pytest.mark.parametrize("src, entry", sorted(LN_INFO_ENTRIES))
def test_layer_norm_info_entries_match_their_readers(src, entry, monkeypatch):
    """Each LayerNorm ``*_info`` entry writes as many ints as its reader names,
    and ``_build.query`` names them in order and raises on a failed query."""
    from cse_tpu_torch.ops import fused_train, kernel_parts

    keys = getattr(fused_train if "bwd" in entry else kernel_parts, LN_INFO_ENTRIES[(src, entry)])
    comment = re.search(rf"((?://[^\n]*\n)+)int {entry}\(", (_build.CSRC / src).read_text()).group(1)
    assert f"info[{len(keys)}]" in comment

    def fake(err):
        def call(*args):
            for i in range(len(keys)):
                args[-1][i] = 10 + i
            return err
        return type("Lib", (), {entry: staticmethod(call)})()

    monkeypatch.setattr(_build, "library", lambda: fake(0))
    assert _build.query(entry, keys, 256, 1, 1) == {k: 10 + i for i, k in enumerate(keys)}
    monkeypatch.setattr(_build, "library", lambda: fake(2))
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _build.query(entry, keys, 256, 1, 1)


def test_staged_layer_norm_width_matches_the_source():
    """kp_layer_norm refuses the bf16 J modes above the staged kernel's widest
    row before it launches: its KPLN_MAXD is the source's."""
    from cse_tpu_torch.ops import kernel_parts

    text = (_build.CSRC / "kernel_parts.cu").read_text()
    assert f"constexpr int KPLN_MAXD = {kernel_parts.KPLN_MAXD};" in text
    assert "D % 16 == 0 && D <= KPLN_MAXD" in text


@pytest.mark.parametrize("src, entry", ROUTE_ENTRIES)
def test_route_codes_match_the_sources(src, entry, monkeypatch):
    """Each bf16 attention launcher routes at L = 256, as the wrappers' docs
    say, and its ``*_info`` entry writes the fields ``launch_info`` reads:
    the key blocks held in registers name the route (0: the multi-pass
    kernel), and a failed query raises."""
    text = (_build.CSRC / src).read_text()
    assert "constexpr int STRIP_MAX_L = 256;" in text
    comment = re.search(rf"((?://[^\n]*\n)+)int {entry}\(", text).group(1)
    assert f"info[{len(_build.INFO_KEYS)}]" in comment

    def fake(key_blocks, err=0):
        def call(*args):
            out = args[-1]
            for i in range(len(_build.INFO_KEYS)):
                out[i] = key_blocks if i == 0 else i
            return err
        return type("Lib", (), {entry: staticmethod(call)})()

    monkeypatch.setattr(_build, "library", lambda: fake(16))
    info = _build.launch_info(entry, 251, 1)
    assert info["route"] == "strip" and [info[k] for k in _build.INFO_KEYS] == [16, 1, 2, 3, 4, 5, 6]
    monkeypatch.setattr(_build, "library", lambda: fake(0))
    assert _build.launch_info(entry, 300, 1)["route"] == "passes"
    monkeypatch.setattr(_build, "library", lambda: fake(0, err=1))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.launch_info(entry, 300, 1)


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
