"""The port's YAML reader (``langstream_tpu_torch/core/yaml_reader.py``)
against ``yaml.safe_load``: every YAML file under ``examples/``, the edges
of the subset it reads, and the constructs it refuses with their line.
PyYAML is imported here only: no port module imports it."""

import math
from pathlib import Path

import pytest
import yaml

from langstream_tpu_torch.core.parser import ModelBuilder, ModelParseError
from langstream_tpu_torch.core.yaml_reader import YamlError, safe_load

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted((ROOT / "examples").rglob("*.yaml"))


def _same(got, want) -> bool:
    """Equal, with NaN equal to NaN (``.nan`` reads as a float NaN)."""
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, dict):
        return (isinstance(got, dict) and list(got) == list(want)
                and all(_same(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_same(a, b) for a, b in zip(got, want)))
    return type(got) is type(want) and got == want


def test_examples_hold_yaml():
    assert len(EXAMPLE_FILES) > 50


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_reader_equals_safe_load_on_examples(path):
    text = path.read_text()
    assert _same(safe_load(text), yaml.safe_load(text))


CASES = {
    "scalars": (
        "a: 1\nb: yes\nc: 'x'\nd: \"y\\n\"\ne: ~\nf: 1.5\ng: 0x1F\nh: 017\ni: 1_000\n"
        "j: 1:30\nk: .inf\nl: -.INF\nm: 2024-01-02\nn: 2024-01-02 10:20:30.5 +02:00\n"
        "o: 1e5\np: .5\nq: On\nr: null\ns: 0b101\nt: 1:30.5\nu: -0\nv: +12\nw: .NaN\n"
        "x: 2001-12-14t21:59:43.10-05:00\ny: 2001-12-14 21:59:43Z\nz: NO\n"
    ),
    "sequences": "- a\n- b: 1\n  c: 2\n- - x\n  - y\n-\n  - z\n- \n",
    "sequence_at_key_indent": "k:\n- 1\n- 2\nz: [a, b, {c: d, e: [1, 2]}]\n",
    "block_scalars": (
        "t: |\n  line1\n   line2\n\n  line3\n\nu: >\n  folded\n  text\n\n  para\n   indented\n"
        "  end\nv: |-\n  strip\n\n\nw: |+\n  keep\n\n\nx: >-\n  a\n  b\n"
    ),
    "block_indicator": "a: |2\n   two\n  one\nb: >1-\n  x\n",
    "block_in_sequence": "- |\n  lit\n- >\n  fold\n- name: x\n  text: |\n    hello\n    world\n  n: 2\n",
    "quoted_multiline": "s: 'it''s\n  multi\n\n  line'\nd: \"a\\\n  b \\u00e9 \\x41 \\t\\\"\"\n",
    "comments": (
        "# comment\nkey: value # trailing\nother: \"quoted # not comment\"\n"
        "hash: a#b\nlist: [a, # c\n  b]\n"
    ),
    "flow_multiline": "flow: {a: 1,\n  b: [x,\n    y], c}\nempty_map: {}\nempty_list: []\n",
    "plain_multiline": "plain: this is\n  a multi line\n\n  plain scalar\nnext: 1\n",
    "document_start": "---\na: 1\n",
    "keys": "\"quoted key\": 1\n'single': 2\n3: three\ntrue: t\nnull: n\n1.5: f\n",
    "colons_and_dashes": "url: http://x.y/z?a=b\ncolon: a:b\ndash: -x\nneg: -3\nmd: '- not a list'\n",
    "nesting": "nested:\n  deeper:\n    deepest: [1]\n  back: 2\nempty:\nlast: ''\n",
    "unicode": "name: café\nemoji: \"\\U0001F600\"\n",
    "windows_newlines": "a: 1\r\nb:\r\n  - x\r\n",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_equals_safe_load_on_edges(name):
    text = CASES[name]
    assert _same(safe_load(text), yaml.safe_load(text))


REFUSED = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: [1]\nb: *ref\n", 2),
    "tag": ("a: 1\nb:\n  c: !!str 3\n", 3),
    "second_document": ("a: 1\n---\nb: 2\n", 2),
    "document_end": ("a: 1\n...\n", 2),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "complex_key": ("x: 1\n? a\n: b\n", 2),
    "merge_key": ("x:\n  <<: {a: 1}\n", 2),
    "unterminated_quote": ("a: 'open\nb: 2\n", 1),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "inline_mapping_value": ("a: b: c\n", 1),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_reader_refuses_outside_the_subset(name):
    text, line = REFUSED[name]
    with pytest.raises(YamlError) as info:
        safe_load(text)
    assert info.value.line == line


def test_parser_names_the_file_and_line(tmp_path):
    app = tmp_path / "app"
    app.mkdir()
    (app / "pipeline.yaml").write_text(
        "id: p\npipeline:\n  - type: identity\n    configuration: &cfg {}\n"
    )
    with pytest.raises(ModelParseError, match=r"pipeline\.yaml:4: line 4: anchors"):
        ModelBuilder.build_application_from_path(app)
