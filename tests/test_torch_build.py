"""The build helper's local headers: ``_build.csrc_source`` splices each
``#include "<name>.cuh"`` of ``csrc/`` into the source's text, so that the
text builds on its own in the build directory and its hash (the library's
name) changes with any header it uses.  No compiler is needed here."""

import re
import shutil

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dec

SOURCES = ["matmul.cu", "flash_attention.cu", "decode_attention.cu"]


@pytest.mark.parametrize("name", SOURCES)
def test_csrc_source_holds_no_local_include(name):
    stem, text = _build.csrc_source(name)
    assert stem == name[:-3]
    assert not re.search(r'#include\s+"', text)
    assert "#pragma once" not in text
    # the shared helpers arrive once, from the header
    assert text.count("__device__ __forceinline__ void mbar_wait(") == 1
    assert text.count("void cp_async16(") == 1


@pytest.mark.parametrize("name", SOURCES)
def test_a_header_edit_changes_every_hash_that_uses_it(tmp_path, name):
    for f in (name, "hopper.cuh"):
        shutil.copy(_build.CSRC_DIR / f, tmp_path / f)
    _, before = _build.csrc_source(name, tmp_path)
    assert before == _build.csrc_source(name)[1]
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n__device__ int edited_helper() { return 1; }\n")
    _, after = _build.csrc_source(name, tmp_path)
    assert "edited_helper" in after
    assert _build.source_hash(after) != _build.source_hash(before)


def test_nested_headers_are_spliced_once(tmp_path):
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner_value = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\nint outer_value;\n')
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n#include "inner.cuh"\n'
                                   "#include <cstdint>\nint main_value;\n")
    stem, text = _build.csrc_source("k.cu", tmp_path)
    assert stem == "k"
    assert text.count("inner_value") == 1 and text.count("outer_value") == 1
    assert "#include <cstdint>" in text             # a system header stays
    assert text.index("inner_value") < text.index("outer_value") < text.index("main_value")


def test_decode_args_match_the_kernels_struct():
    """The packed twin of ``DecodeArgs`` names the C struct's fields in its
    order and with its types (a mismatch would shift every field after it)."""
    _, text = _build.csrc_source("decode_attention.cu")
    body = re.search(r"struct DecodeArgs \{(.*?)\};", text, re.S).group(1)
    c_fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = re.match(r"((?:const )?[\w ]+?\**)\s*(\w+(?:,\s*\w+)*)$", decl).groups()
        kind = ("pointer" if "*" in ctype else "int64" if "long long" in ctype
                else "float" if ctype.strip() == "float" else "int32")
        c_fields += [(n.strip(), kind) for n in names.split(",")]

    kinds = {"P": "pointer", "q": "int64", "i": "int32", "f": "float"}
    assert [(n, kinds[code]) for n, code in dec.ARGS_FIELDS] == c_fields
    # no padding between the groups; the end padded to 8 bytes, as sizeof is
    assert dec._ARGS.size == 9 * 8 + 8 * 8 + 9 * 4 + 2 * 4 + 4
