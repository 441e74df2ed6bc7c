"""The port's YAML reader (``pq3d_tpu_torch/utils/yaml_reader.py``) against
PyYAML's ``yaml.safe_load``: equal values of equal types.

- the JAX package's six config files;
- one hand case a form of the subset (each scalar resolution, the quoted
  styles, comments, block and flow collections);
- a property: random nested dicts and lists of the subset's scalars,
  written by ``yaml.safe_dump`` in block style, in flow style and mixed,
  at narrow and wide line widths (so long scalars fold over lines), read
  back equal to what PyYAML reads;
- each refused form raises ``ValueError`` naming its line."""
import glob
import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from pq3d_tpu_torch.utils import yaml_reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = sorted(glob.glob(os.path.join(REPO, "pq3d_tpu", "config",
                                            "configs", "*.yaml")))


def same(a, b):
    """Equal values of equal types, key order included; NaN equals
    NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    return a == b


def test_six_config_files():
    assert len(JAX_CONFIGS) == 6


@pytest.mark.parametrize("path", JAX_CONFIGS,
                         ids=[os.path.basename(p) for p in JAX_CONFIGS])
def test_config_file_reads_as_pyyaml_reads_it(path):
    with open(path) as f:
        text = f.read()
    assert same(yaml_reader.loads(text), yaml.safe_load(text))
    assert same(yaml_reader.load(path), yaml.safe_load(text))


HAND = [
    # null
    "a: null", "a: ~", "a:", "a: Null", "a: NULL", "",
    # bools, three casings
    "a: yes", "a: No", "a: TRUE", "a: false", "a: On", "a: OFF", "a: y",
    # ints
    "a: 12", "a: -7", "a: +3", "a: 0", "a: 0x1F", "a: -0x1f", "a: 017",
    "a: 08", "a: 0b101", "a: 1_000", "a: 1:30", "a: -1:30:05",
    # floats: a dot needed, an exponent signed
    "a: 1.5", "a: 1.", "a: .5", "a: -2.5", "a: 1e-4", "a: 1E5",
    "a: 1.0e-4", "a: 1.0e+4", "a: 1.0e4", "a: 1_0.5", "a: 1:30.5",
    "a: .inf", "a: -.Inf", "a: +.INF", "a: .nan", "a: .NaN", "a: inf",
    # strings, plain and quoted
    "a: plain words", "a: 'single ''quoted'''", 'a: "tab\\there \\u00e9"',
    'a: "\\x41\\U0001F600\\\\\\""', "a: '#kept'", 'a: "# kept"',
    "a: x#y", "a: url://x:1", "a: -x", "a: ''", 'a: ""', "a: 'yes'",
    # comments
    "# only a comment", "a: 1  # trailing\n# full line\nb: 2",
    # folding
    "a: one\n  two\n\n  three", "a: 'one\n  two'", 'a: "one\\\n  two"',
    # block collections
    "a:\n- 1\n- 2\nb: 3", "a:\n  - [1, 2]\n  - {x: y}",
    "- - a\n  - b\n- c", "- a: 1\n  b: 2\n- c: 3", "-\n  a\n- ",
    "a:\n  b:\n    c: [1, 2]\n  d: 4",
    # flow collections, nested, over lines, quoted keys
    "a: [b, [c, {d: e}], {'f g': \"h\"}]", "a: [1,\n   2,\n   3]",
    "{a: 1, b: [], c: {}}", "a: {x: 1,}", "a: [x, y,]", '{"a":1}',
    "a: {b}",
]


@pytest.mark.parametrize("text", HAND)
def test_hand_case_reads_as_pyyaml_reads_it(text):
    assert same(yaml_reader.loads(text), yaml.safe_load(text))


_CHARS = list("abXY09 -_.:#,[]{}'\"\\/?!&*|>%@`~=<\u00e9\t\n\x85")
_KEY_CHARS = [c for c in _CHARS if c not in "\t\n\x85"]
_SCALARS = st.one_of(st.none(), st.booleans(),
                     st.integers(-10**12, 10**12),
                     st.floats(allow_nan=True),
                     st.text(st.sampled_from(_CHARS), max_size=14))
# a key is a non-empty one-line string (PyYAML writes others as the
# complex keys the reader refuses), an int, a bool or None
_KEYS = st.one_of(st.text(st.sampled_from(_KEY_CHARS), min_size=1,
                          max_size=10),
                  st.integers(-100, 100), st.booleans(), st.none())
_TREES = st.recursive(
    _SCALARS, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(_KEYS, inner, max_size=4)), max_leaves=20)
_DOCS = st.one_of(st.lists(_TREES, max_size=4),
                  st.dictionaries(_KEYS, _TREES, max_size=4))


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(_DOCS, st.sampled_from([False, True, None]),
       st.sampled_from([20, 80, 1000]), st.sampled_from([2, 4]))
def test_safe_dump_reads_back_as_pyyaml_reads_it(doc, flow, width, indent):
    text = yaml.safe_dump(doc, default_flow_style=flow, sort_keys=False,
                          width=width, indent=indent)
    assert same(yaml_reader.loads(text), yaml.safe_load(text)), text


REFUSED = {
    "anchor": ("a: 1\nb: &x 2", 2),
    "alias": ("a: [1]\nb: *x", 2),
    "tag": ("a: !!str 1", 1),
    "block_literal": ("a: |\n  text", 1),
    "block_folded": ("a: >\n  text", 1),
    "merge_key": ("base: {x: 1}\n<<: {y: 2}", 2),
    "second_document": ("a: 1\n---\nb: 2", 2),
    "document_start": ("---\na: 1", 1),
    "directive": ("%YAML 1.1\na: 1", 1),
    "complex_key": ("? a\n: b", 1),
    "collection_key": ("a: 1\n[b, c]: d", 2),
    "flow_pair": ("a: [b: c]", 1),
    "timestamp": ("a: 1\nb: 2001-12-14", 2),
    "tab": ("a:\n\tb: 1", 2),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_form_names_its_line(case):
    text, line = REFUSED[case]
    with pytest.raises(ValueError, match=f"YAML line {line}:"):
        yaml_reader.loads(text)
