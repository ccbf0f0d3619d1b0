"""The port's YAML reader (``gordo_components_torch/utils/yaml_subset.py``)
against ``yaml.safe_load`` (PyYAML, YAML 1.1), on the CPU.

Equal results, compared with types (an int is not a float, a date not a
string) and key order, on every fleet file and YAML block of the repo's
examples, docs and tests, on one case per construct of the subset, on every
YAML 1.1 scalar rule fleet files meet, and on seeded documents that
``yaml.safe_dump`` writes. Every construct outside the subset raises
``YAMLSubsetError`` with a line number and returns nothing.
"""

import datetime
import math
import os
import random
import re

import pytest
import yaml

from gordo_components_torch.utils.yaml_subset import YAMLSubsetError, safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, datetime.datetime):
        return a == b and a.tzinfo == b.tzinfo
    return a == b


def assert_same(text):
    want = yaml.safe_load(text)
    got = safe_load(text)
    assert same(got, want), (got, want)
    return got


def _docs_blocks():
    with open(os.path.join(REPO, "docs", "configs.md")) as f:
        return re.findall(r"```yaml\n(.*?)```", f.read(), re.S)


def _repo_texts():
    from test_workflow import CONFIG_YAML

    with open(os.path.join(REPO, "examples", "fleet.yaml")) as f:
        texts = {"examples/fleet.yaml": f.read()}
    texts.update({f"docs/configs.md block {i}": b for i, b in enumerate(_docs_blocks())})
    texts["tests/test_workflow.py CONFIG_YAML"] = CONFIG_YAML
    return texts


REPO_TEXTS = _repo_texts()


@pytest.mark.parametrize("name", sorted(REPO_TEXTS))
def test_repo_yaml_reads_as_pyyaml_reads_it(name):
    assert_same(REPO_TEXTS[name])


def test_every_docs_block_is_read():
    assert len(_docs_blocks()) >= 3


def test_fleet_yaml_keeps_quoted_dates_as_strings_and_the_fleet_block():
    doc = assert_same(REPO_TEXTS["examples/fleet.yaml"])
    assert doc["machines"][0]["dataset"]["train_start_date"] == "2020-01-01T00:00:00Z"
    assert doc["fleet"]["schedules"]["refit_every"] == "6h"


CONSTRUCTS = {
    "block mapping": "a: 1\nb: two\n",
    "nested block mapping": "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "block sequence": "- 1\n- two\n",
    "sequence at its key's indentation": "a:\n- 1\n- 2\nb: 3\n",
    "sequence under its key": "a:\n  - 1\n  - 2\n",
    "item mapping continuing below": "- name: m1\n  dataset:\n    tags: [a]\n- name: m2\n",
    "sequence of sequences": "- - a\n  - b\n- c\n",
    "flow sequence": "k: [a, 1, 2.5, null]\n",
    "flow mapping": "k: {a: 1, b: x}\n",
    "nested flow": "k: [[a, b], {c: [1, {d: e}]}, []]\n",
    "flow over several lines": "k: {a: 1,\n  b: [1,\n     2]}  # c\nz: 0\n",
    "flow mapping entry without value": "k: {a, b: 1, c: }\n",
    "flow trailing comma": "k: [a, b, ]\n",
    "json": '{"machines": [{"name": "m1", "dataset": {"x": 1.5, "y": true, "z": null}}]}',
    "json over several lines": '{\n  "a": [\n    1,\n    "b"\n  ],\n  "c": {}\n}\n',
    "plain with spaces": "k: a b   c\n",
    "plain with inner colon and hash": "k: http://host:80/p#frag\n",
    "single quotes": "k: 'it''s # not a comment'\n",
    "double quotes and escapes": 'k: "a\\tb\\n\\u00e9\\x41\\/\\\\\\"\\U0001F600"\n',
    "quoted key": '"a: b": 1\n\'c\': 2\n',
    "whole-line and trailing comments": "# top\na: 1  # one\n  # indented\nb: 2\n",
    "empty values": "a:\nb: ~\nc: null\nd:\n- \n- x\n",
    "empty document": "",
    "comments only": "# a\n\n  # b\n",
    "top-level scalar": "foo\n",
    "top-level flow": "[1, 2]\n",
    "indented document": "  a: 1\n  b: 2\n",
    "duplicate key: last wins": "a: 1\na: 2\n",
    "scalar keys resolve": "1: a\nyes: b\n2020-01-01: c\n~: d\n",
    "crlf line ends": "a: 1\r\nb:\r\n  - x\r\n",
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTS))
def test_construct(name):
    assert_same(CONSTRUCTS[name])


UTC = datetime.timezone.utc
# YAML 1.1 scalar rules: (scalar, what yaml.safe_load gives for it)
SCALARS = [
    ("2020-01-01T00:00:00Z", datetime.datetime(2020, 1, 1, tzinfo=UTC)),
    ("2020-01-01", datetime.date(2020, 1, 1)),
    ("2001-12-14 21:59:43.10 -5", datetime.datetime(2001, 12, 14, 21, 59, 43, 100000,
                                                    tzinfo=datetime.timezone(-datetime.timedelta(hours=5)))),
    ("2001-12-14t21:59:43.1234567+05:30", datetime.datetime(
        2001, 12, 14, 21, 59, 43, 123456, tzinfo=datetime.timezone(datetime.timedelta(hours=5, minutes=30)))),
    ("2020-01-01T00:00:00", datetime.datetime(2020, 1, 1)),
    ("2020-1-1", "2020-1-1"),
    ("yes", True), ("On", True), ("FALSE", False), ("off", False), ("No", False), ("y", "y"),
    ("nULL", "nULL"),
    ("~", None), ("null", None), ("Null", None), ("", None),
    ("017", 15), ("-017", -15), ("09", "09"), ("0x1f", 31), ("0b101", 5), ("1_000", 1000), ("1:30", 90),
    ("+12", 12), ("-0", 0), ("0_", 0), ("12:70", "12:70"),
    ("1e3", "1e3"), ("1.0e3", "1.0e3"), ("1.0e+3", 1000.0), ("-1.5e-3", -0.0015), ("3.14", 3.14),
    ("0.", 0.0), (".5", 0.5), ("1:30.5", 90.5), (".inf", math.inf), ("-.Inf", -math.inf),
    (".nan", math.nan), ("0o17", "0o17"),
    ("10min", "10min"), ("6h", "6h"), ("-foo", "-foo"), (":foo", ":foo"), ("?foo", "?foo"), ("a#b", "a#b"),
]


@pytest.mark.parametrize("scalar, want", SCALARS, ids=[repr(s) for s, _ in SCALARS])
def test_yaml_11_scalars(scalar, want):
    for text in (f"k: {scalar}\n", f"- {scalar}\n"):
        got = assert_same(text)
        value = got["k"] if isinstance(got, dict) else got[0]
        assert same(value, want), (text, value, want)
    if scalar and not scalar.startswith((":", "?")):  # indicators in a flow collection
        assert_same(f"[{scalar}]\n")


REFUSED = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: *x\n",
    "tag": "a: !!str 1\n",
    "local tag": "- !thing {}\n",
    "document start": "---\na: 1\n",
    "document end": "a: 1\n...\n",
    "directive": "%YAML 1.1\na: 1\n",
    "literal block scalar": "a: |\n  x\n",
    "folded block scalar": "a: >\n  x\n",
    "complex key": "? a\n: b\n",
    "merge key": "<<: {a: 1}\nb: 2\n",
    "value indicator": "a: =\n",
    "plain over several lines": "a: b\n  c\n",
    "quoted over several lines": "a: 'x\n  y'\n",
    "double-quoted line continuation": 'a: "x\\\n  y"\n',
    "tab": "a:\tb\n",
    "mapping value on a value's line": "a: b: c\n",
    "unclosed flow": "a: [1, 2\n",
    "pair in a flow sequence": "[a: 1]\n",
    "sequence on its key's line": "a: - b\n",
    "key after a top-level sequence": "- a\nb: c\n",
    "stray indentation": "a: 1\n - b\n",
    "comment without a space": "a: [1]#c\n",
    "unknown escape": 'a: "\\q"\n',
    "reserved indicator": "a: @x\n",
    "backquote": "a: `x`\n",
    "empty flow entry": "[a, , b]\n",
    "flow key": "{[a]: 1}\n",
    "text after a quoted value": 'a: "x" y\n',
    "bad hex int": "k: 0x_\n",
    "control character": "a: \x07\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_constructs_raise_with_a_line(name):
    with pytest.raises(YAMLSubsetError, match=r"^line \d+: "):
        safe_load(REFUSED[name])


def test_refusal_names_its_line():
    with pytest.raises(YAMLSubsetError) as info:
        safe_load("machines:\n  - name: a\n    model: &m {}\n")
    assert info.value.line == 3 and isinstance(info.value, ValueError)


def test_reads_files_and_bytes(tmp_path):
    path = tmp_path / "f.yaml"
    path.write_text(CONSTRUCTS["item mapping continuing below"])
    with open(path) as f:
        assert safe_load(f) == yaml.safe_load(CONSTRUCTS["item mapping continuing below"])
    assert safe_load(b"a: [1]\n") == {"a": [1]}


_WORDS = ["a", "b c", "yes", "no", "1e3", "0x1f", "null", "~", "-x", "x: y", "#h", "a #b", "it's", 'q"t',
          "10min", "", " lead", "trail ", "[x]", "{y}", "a,b", "\u00e9", "2020-01-01", "017", "1_0", ":", "-",
          "?", "*a", "&b", "!t", "%p", "@", "`"]


def _random_doc(rng, depth=0):
    r = rng.random()
    if depth > 3 or (depth and r < 0.4):
        r = rng.random()
        if r < 0.45:
            return rng.choice(_WORDS)
        if r < 0.6:
            return rng.randint(-1000, 1000)
        if r < 0.75:
            return rng.choice([0.5, -2.25, 1e20, 1.5e-7, math.inf])
        if r < 0.9:
            return rng.choice([True, False, None])
        return datetime.date(2020, 1, 2)
    if r < 0.7:
        return {f"{rng.choice(_WORDS)}{i}": _random_doc(rng, depth + 1) for i in range(rng.randint(0, 4))}
    return [_random_doc(rng, depth + 1) for _ in range(rng.randint(0, 4))]


@pytest.mark.parametrize("style", [None, True, False], ids=["mixed", "flow", "block"])
def test_documents_pyyaml_writes(style):
    rng = random.Random(7)
    for _ in range(200):
        doc = _random_doc(rng)
        text = yaml.safe_dump(doc, default_flow_style=style, width=10**6,
                              allow_unicode=rng.random() < 0.5, indent=rng.choice([2, 4]))
        assert_same(text)
