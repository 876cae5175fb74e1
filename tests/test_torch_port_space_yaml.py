"""The port's YAML reader for search spaces (``pmgt_tpu_torch/cli/
space_yaml.py``) against ``yaml.safe_load`` (PyYAML, which the card machine
lacks): every ``config/hpo/*.yaml`` parses equal; generated spaces in the
supported subset, with scalars of every kind (floats with and without a
dot or an exponent sign, ints in every base, booleans, nulls, paths,
quoted strings) and comments, parse equal; syntax outside the subset
raises ``ValueError`` naming its line."""
import glob
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pmgt_tpu_torch.cli import space_yaml

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "hpo")
YAMLS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_every_shipped_space_parses_like_safe_load(path):
    text = open(path, encoding="utf-8").read()
    assert space_yaml.load(text) == yaml.safe_load(text)


def test_the_float_trap():
    """PyYAML 1.1: a float needs a dot, and its exponent a sign."""
    got = space_yaml.load("a: 1e-5\nb: 1.0e-5\nc: 1.0e5\nd: 1.5E+3\ne: 5.\nf: .5\n")
    assert got == {"a": "1e-5", "b": 1e-5, "c": "1.0e5", "d": 1500.0, "e": 5.0, "f": 0.5}


_FIXED = [
    "0", "7", "-3", "+5", "1_000", "012", "0x1F", "0b101", "1:30", "-0",
    "1.0e-5", "1.0e+3", "0.5", "-2.25", ".5", "1.", "1.0", "3.0e-4", "-.inf", ".Inf",
    "1e-5", "1.0e5", "1e4", "1.0e-5x", "12abc", "0.5.1",
    "true", "True", "TRUE", "false", "yes", "No", "on", "Off", "y", "n",
    "null", "~", "Null", "NULL", "none",
    "./data/VG/node_feat4_32dim.npy", "a/b_c-d.txt", "NeuMF-end", "GMF",
    "43b392b5e92346e581167c048dcd71a4", "x y z", "http://h/p?q=1", "a#b",
    "'it''s'", "'1.0'", '"a b"', '"tab\\tnew\\nline"', "'#not a comment'",
]


def _float_texts(x):
    return st.sampled_from([repr(x), f"{x:.3e}", f"{x:e}", f"{x:g}", f"{x:.6f}"])


SCALARS = st.one_of(
    st.sampled_from(_FIXED),
    st.floats(min_value=-1e6, max_value=1e6, allow_nan=False).flatmap(_float_texts),
    st.integers(min_value=-10**6, max_value=10**6).map(str),
)
KEYS = st.sampled_from(["lr", "decay", "factor_num", "value", "type", "round", "step",
                        "cond", "cond_type", "cond_value", "cond_param", "prune",
                        "item_init_emb_path", "num_layers", "x_1", "seed"])
COMMENTS = st.sampled_from(["", "", " # a comment", " # x: [1, 2] # & * !"])


def _flow(items):
    return "[" + ", ".join(items) + "]"


FLOWS = st.recursive(
    st.lists(SCALARS, max_size=4).map(_flow),
    lambda inner: st.lists(st.one_of(SCALARS, inner), max_size=3).map(_flow),
    max_leaves=6,
)


def _blocks(children):
    """A block mapping or block sequence over ``children`` (each a
    function of the indentation giving lines)."""
    entry = st.tuples(KEYS, st.one_of(SCALARS, FLOWS, children), COMMENTS)
    mapping = st.lists(entry, min_size=1, max_size=4).map(lambda es: ("map", es))
    seq = st.tuples(st.lists(st.one_of(SCALARS, FLOWS, children), min_size=1, max_size=3),
                    st.booleans()).map(lambda s: ("seq", s))
    return st.one_of(mapping, seq)


NODES = st.recursive(st.one_of(SCALARS, FLOWS), _blocks, max_leaves=12)


def _render(node, indent, lines, comment_line):
    pad = " " * indent
    kind = node[0] if isinstance(node, tuple) else None
    if kind == "map":
        for key, value, comment in node[1]:
            if isinstance(value, tuple) and value[0] == "map":
                lines.append(f"{pad}{key}:{comment}")
                _render(value, indent + 2, lines, comment_line)
            elif isinstance(value, tuple):
                lines.append(f"{pad}{key}:{comment}")
                # a sequence under a key: indented, or at the key's column
                _render(value, indent + (2 if value[1][1] else 0), lines, comment_line)
            else:
                lines.append(f"{pad}{key}: {value}{comment}")
            if comment_line:
                lines.append(f"{pad}# between entries")
    else:
        for item in node[1][0]:
            if isinstance(item, tuple) and item[0] == "map":
                sub = []
                _render(item, indent + 2, sub, False)
                sub[0] = pad + "- " + sub[0][indent + 2:]
                lines.extend(sub)
            elif isinstance(item, tuple):
                lines.append(f"{pad}-")
                _render(item, indent + 2, lines, False)
            else:
                lines.append(f"{pad}- {item}")


def _parses_like_safe_load(text):
    """Equal values; where PyYAML refuses the text, the reader raises
    ``ValueError`` (it never returns a value PyYAML would not)."""
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError, match="^line [0-9]+: "):
            space_yaml.load(text)
        return
    assert space_yaml.load(text) == want, text


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(node=NODES.filter(lambda n: isinstance(n, tuple)), comment_line=st.booleans())
def test_generated_spaces_parse_like_safe_load(node, comment_line):
    lines = ["# a generated space"]
    _render(node, 0, lines, comment_line)
    _parses_like_safe_load("\n".join(lines) + "\n")


@settings(max_examples=300, deadline=None, database=None)
@given(st.one_of(SCALARS, FLOWS), COMMENTS)
def test_generated_scalars_parse_like_safe_load(value, comment):
    _parses_like_safe_load(f"key: {value}{comment}\n")


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: *alias\n", 1),
    ("a: !!float 1\n", 1),
    ("a: |\n  block\n", 1),
    ("a: >\n  folded\n", 1),
    ("a:\n  b: {c: 1}\n", 2),
    ("a: hello\n  world\n", 2),
    ("a: [1,\n  2]\n", 1),
    ("a: 'x\n  y'\n", 1),
    ("x: 1\n? complex\n: key\n", 2),
    ("---\na: 1\n", 1),
    ("%YAML 1.1\na: 1\n", 1),
    ("a: 1\n\tb: 2\n", 2),
    ("a: 2015-01-01\n", 1),
    ("a: b: c\n", 1),
    ("a:\n  - x\n  y: 1\n", 3),
    ("a: [x: 1]\n", 1),
])
def test_unsupported_syntax_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"^line {line}: "):
        space_yaml.load(text)


def test_empty_and_comment_only_documents():
    assert space_yaml.load("") is None
    assert space_yaml.load("# nothing\n\n") is None
