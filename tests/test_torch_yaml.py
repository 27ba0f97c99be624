"""The port's YAML reader (``midi_vae_tpu_torch/io/yaml_read.py``, behind
``train/config.py`` ``read_yaml``) against PyYAML's ``yaml.safe_load``,
which the JAX package reads ``--config`` with: the same Python objects,
types and key order, and a ``ValueError`` naming the file and line
wherever ``safe_load`` raises.

- generated documents: nested dicts, lists and scalars (ints, floats,
  bools, None, dates, bytes, sets, strings full of YAML's indicators)
  rendered by ``yaml.safe_dump`` in block, flow and mixed styles, plain,
  single- and double-quoted, at narrow widths (folded multi-line scalars),
  with shared objects (anchors and aliases): 9 styles × 60 documents;
- generated token soups (fragments of YAML syntax strung together), which
  either both readers read alike or both refuse;
- the committed forms of ``tests/fixtures/yaml_forms/`` (each beside the
  ``.json`` of what ``safe_load`` returned; ``chip_smoke.py`` holds the
  reader to them on the GPU machine, which has no PyYAML), forms JSON
  cannot hold (dates, non-string keys, ``!!set``/``!!omap``/``!!binary``),
  and documents ``safe_load`` refuses;
- ``tests/fixtures/folded_block.yaml``, ``configs/folded.yaml`` in block
  style with an anchor and a merge key, resolves to the same
  ``TrainConfig`` in both packages.
"""

import glob
import json
import math
import os

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from midi_vae_tpu.train.config import from_yaml as jax_from_yaml
from midi_vae_tpu_torch.train.config import from_yaml, read_yaml
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMS = sorted(glob.glob(os.path.join(_REPO, "tests", "fixtures", "yaml_forms", "*.yaml")))
FOLDED_BLOCK = os.path.join(_REPO, "tests", "fixtures", "folded_block.yaml")


def same(a, b) -> bool:
    """Equal values of the same types, dict keys in the same order, NaN equal
    to NaN and -0.0 apart from 0.0."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return len(a) == len(b) and all(same(ka, kb) and same(va, vb)
                                        for (ka, va), (kb, vb) in zip(a.items(), b.items()))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or (a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


def safe_load_file(path: str):
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f)


def assert_reads_as_safe_load(path: str):
    """``read_yaml`` returns what ``safe_load`` returns, or raises a
    ``ValueError`` naming the file and line where it raises (``safe_load``
    raises more than ``yaml.YAMLError``: ``!!int ''`` is an ``IndexError``)."""
    try:
        want = safe_load_file(path)
    except (yaml.YAMLError, ValueError, KeyError, IndexError, AttributeError):
        with pytest.raises(ValueError, match=r", line \d+: ") as e:
            read_yaml(path)
        assert str(e.value).startswith(path)
        return None
    got = read_yaml(path)
    assert same(got, want), (got, want)
    return got


@pytest.fixture(scope="module")
def doc_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("yaml") / "doc.yaml")


def write(path: str, text: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


# ------------------------------------------------------- generated documents

_INDICATORS = list(" :#-?[]{},&*!|>'\"%@`\\\n\t~=<._+0123456789eExXbo") + ["a", "y", "N", "é", "\x85", "\u2028",
                                                                             "\x00", "\U0001F600"]
_LOOKALIKES = ["yes", "No", "on", "OFF", "~", "null", "0x10", "010", "0o17", "0b11", "1_000", "1:30", "1e-3", "1.",
               ".inf", "-.Inf", ".NaN", "2001-12-14", "2001-12-14 21:59:43.1", "<<", "=", "---", "...", "- a",
               "a: b", "# c", "", " lead", "trail ", "!!str", "&a", "*a", "|", ">", "'", '"',
               "a key too long for a simple key " * 5]
TEXT = st.one_of(st.text(st.sampled_from(_INDICATORS), max_size=14), st.text(max_size=8),
                 st.sampled_from(_LOOKALIKES))
SCALARS = st.one_of(TEXT, st.integers(-(2**70), 2**70), st.floats(), st.booleans(), st.none(), st.dates(),
                    st.datetimes(), st.binary(max_size=24))
KEYS = st.one_of(TEXT, st.integers(-1000, 10**6), st.booleans(), st.none(), st.floats(allow_nan=False))
VALUES = st.recursive(
    st.one_of(SCALARS, st.sets(st.text(st.sampled_from(_INDICATORS), max_size=4), max_size=3)),
    lambda inner: st.one_of(st.lists(inner, max_size=4), st.dictionaries(KEYS, inner, max_size=4)),
    max_leaves=10,
)


@st.composite
def documents(draw):
    """A root mapping; sometimes one collection twice (anchor and alias)."""
    root = draw(st.dictionaries(KEYS, VALUES, max_size=5))
    shared = draw(st.one_of(st.none(), st.lists(SCALARS, min_size=1, max_size=3),
                            st.dictionaries(TEXT, SCALARS, min_size=1, max_size=3)))
    if shared is not None:
        root["first"] = shared
        root["later"] = [1, shared]
    return root


@pytest.mark.parametrize("style", [None, '"', "'"], ids=["plain", "double", "single"])
@pytest.mark.parametrize("flow", [False, True, None], ids=["block", "flow", "mixed"])
@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=documents(), width=st.sampled_from([8, 20, 80]), indent=st.sampled_from([2, 4]),
       allow_unicode=st.booleans())
def test_generated_documents_read_as_safe_load(doc_path, flow, style, data, width, indent, allow_unicode):
    text = yaml.safe_dump(data, default_flow_style=flow, default_style=style, width=width, indent=indent,
                          allow_unicode=allow_unicode, sort_keys=False)
    assert assert_reads_as_safe_load(write(doc_path, text)) is not None or data == {}


_FRAGMENTS = ["-", " ", " ", "  ", "\n", "\n", ":", ": ", "- ", "[", "]", "{", "}", ",", ", ", "#", " #c", "'", '"',
              "&a ", "*a", "&b ", "*b", "!!str ", "! ", "!!int ", "!!set ", "!x ", "|", ">", "|-", ">+", "|2", "a",
              "b", "1", "0x1", "1.5", "?", "? ", "---", "...", "\t", "yes", "~", "<<", "<<: ", "=", "\\", "\\n",
              "''", "%YAML 1.1\n", "x y", "2001-01-01", "1:2", "!e!", "%TAG !e! tag:yaml.org,2002:\n", "\u2028"]


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(parts=st.lists(st.sampled_from(_FRAGMENTS), min_size=1, max_size=25))
def test_token_soup_reads_or_raises_as_safe_load(doc_path, parts):
    assert_reads_as_safe_load(write(doc_path, "".join(parts)))


# ------------------------------------------------------------ written forms


@pytest.mark.parametrize("path", FORMS, ids=lambda p: os.path.basename(p)[: -len(".yaml")])
def test_yaml_forms_read_as_safe_load_and_their_json(path):
    got = assert_reads_as_safe_load(path)
    with open(path[: -len(".yaml")] + ".json", encoding="utf-8") as f:
        assert same(got, json.load(f))


def test_yaml_forms_cover_f4s_rows():
    """Every row of F4's table (ROADMAP Queue 3) is in ``f4_table.yaml``,
    read as ``safe_load`` reads it."""
    got = read_yaml(os.path.join(_REPO, "tests", "fixtures", "yaml_forms", "f4_table.yaml"))
    assert got["hidden_dims"] == [48, 64] and got["sizes"] == {"a": 1}
    assert got["tags"] == ["a, b", "c"] and got["x"] == [[1, 2], [3]]
    assert (got["lr"], got["s"]) == (16, 8) and got["merged"] == {"k1": 1, "k2": 3}
    assert (got["note"], got["k"]) == ("line1\nline2\n", "a b\n")


CPU_ONLY = {
    "dates": "d: 2001-12-14\nt: 2001-12-14t21:59:43.10-05:00\ns: 2001-12-14 21:59:43.10\nz: 2001-12-15T02:59:43.1Z\n"
             "u: 2002-12-14 1:02:03 +5\nf: 2001-12-14 21:59:43.1234567\n",
    "non_string_keys": "1: int\n1.5: float\nyes: bool\n~: null\n2001-01-01: date\n0x10: hex\n",
    "set_omap_pairs": "s: !!set {a, b}\no: !!omap [x: 1, y: 2]\np: !!pairs [x: 1, x: 2]\n",
    "binary": "b: !!binary |\n  aGVsbG8sIHlh\n  bWwgd29ybGQ=\n",
    "recursive_merge_in_sequence": "a: &a {x: 1}\nb: &b {y: 2}\nc:\n  - <<: [*a, *b]\n    z: 3\n",
    "duplicate_keys_last_wins": "k: 1\nk: 2\nj: 3\n",
    "negative_zero": "a: -0.0\nb: -0\nc: +0.0\n",
    "scalar_root": "just a scalar\n",
    "sequence_root": "- 1\n- two\n",
    "crlf_lines": "a: 1\r\nb:\r\n- 2\r\n",
    "raw_line_separators": "a: 'x\u2028y'\nb: \"p\x85q\"\n",
}


@pytest.mark.parametrize("name", sorted(CPU_ONLY))
def test_forms_json_cannot_hold_read_as_safe_load(doc_path, name):
    assert assert_reads_as_safe_load(write(doc_path, CPU_ONLY[name])) is not None


REFUSED = {
    "tab_indentation": "a:\n\t- 1\n",
    "tab_after_value": "a: 1\t\n",
    "undefined_alias": "a: *nowhere\n",
    "duplicate_anchor": "a: &x 1\nb: &x 2\n",
    "second_document": "a: 1\n---\nb: 2\n",
    "unsafe_tag": "a: !!python/object:os.system x\n",
    "python_name_tag": "a: !!python/name:os.system\n",
    "local_tag": "a: !thing x\n",
    "bad_indentation": "a:\n  b: 1\n c: 2\n",
    "sequence_after_mapping": "a: 1\n- b\n",
    "mapping_values_not_allowed": "a: b: c\n",
    "unhashable_key": "[1, 2]: x\n",
    "mapping_key": "? {a: 1}\n: x\n",
    "unclosed_quote": "a: 'open\n",
    "unclosed_flow": "a: [1, 2\n",
    "bad_escape": 'a: "\\q"\n',
    "non_printable": "a: \x07\n",
    "merge_of_a_scalar": "a: 1\nb:\n  <<: x\n",
    "merge_key_as_an_item": "- <<\n",
    "bad_int": "a: !!int abc\n",
    "hex_without_digits": "a: 0x_\n",
    "zero_indentation_indicator": "a: |0\n  x\n",
    "document_end_alone": "...\n",
    "incompatible_version": "%YAML 2.0\n---\na: 1\n",
    "undefined_tag_handle": "a: !e!str x\n",
    "value_without_key": ": x\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_documents_safe_load_refuses_raise_naming_file_and_line(doc_path, name):
    path = write(doc_path, REFUSED[name])
    with pytest.raises((yaml.YAMLError, ValueError)):
        safe_load_file(path)
    assert assert_reads_as_safe_load(path) is None


def test_error_names_the_file_and_line(doc_path):
    with open(os.path.join(_REPO, "tests", "fixtures", "yaml_forms", "f4_table.yaml"), encoding="utf-8") as f:
        text = f.read().replace("s: 010\n", "s: 010\n\tbad: 1\n")  # a tab on line 11
    with pytest.raises(ValueError, match=r"doc\.yaml, line 11: found character '\\t'"):
        read_yaml(write(doc_path, text))


# --------------------------------------------------- block-style config


def test_block_style_config_resolves_to_folded_yaml_in_both_packages():
    flow = os.path.join(_REPO, "configs", "folded.yaml")
    want = jax_from_yaml(flow).to_dict()
    assert from_yaml(FOLDED_BLOCK).to_dict() == want == from_yaml(flow).to_dict()
    assert jax_from_yaml(FOLDED_BLOCK).to_dict() == want
    assert_reads_as_safe_load(FOLDED_BLOCK)

