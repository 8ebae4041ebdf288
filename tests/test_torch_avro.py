"""The port's Avro codec (``langstream_tpu_torch/api/avro.py``) against the
JAX package's: canonical forms, fingerprints and encoded bytes equal, the
port decoding the JAX package's bytes to the same datum, the JSON helpers
and the errors equal — over every schema of ``tests/test_avro.py`` and a few
more, with seeded data from numpy. Then ``MutableRecord``'s Avro paths (an
edit that fits the schema stays Avro under it, one that does not falls back
to JSON or raises) and the ``compute`` step over an Avro record, against the
JAX package's."""

import asyncio
import json

import numpy as np
import pytest

from langstream_tpu.agents.genai.agent import GenAIToolKitAgent as JaxToolKit
from langstream_tpu.agents.genai.mutable import MutableRecord as JaxMutable
from langstream_tpu.api import avro as jax_avro
from langstream_tpu.api.record import SimpleRecord as JaxRecord
from langstream_tpu_torch.agents.genai.agent import GenAIToolKitAgent
from langstream_tpu_torch.agents.genai.mutable import MutableRecord
from langstream_tpu_torch.api import avro
from langstream_tpu_torch.api.record import SimpleRecord

from test_avro import USER, USER_SCHEMA

SCHEMAS = {
    "user": USER_SCHEMA,
    "node": """{"type": "record", "name": "Node", "fields": [
        {"name": "v", "type": "int"},
        {"name": "next", "type": ["null", "Node"], "default": null}]}""",
    "outer": """{"type": "record", "name": "Outer", "fields": [
        {"name": "inner", "type": {"type": "record", "name": "Inner",
          "fields": [{"name": "x", "type": "long"}]}}]}""",
    "other": '{"type": "record", "name": "Other", "fields": []}',
    "user_doc": USER_SCHEMA.replace('"type": "record",', '"doc": "d", "type": "record",'),
    "namespaced": """{"type": "record", "name": "Event", "namespace": "a.b", "fields": [
        {"name": "id", "type": "long"},
        {"name": "payload", "type": {"type": "record", "name": "Payload",
          "namespace": "c", "fields": [{"name": "f", "type": "float"}]}},
        {"name": "again", "type": ["null", "c.Payload"], "default": null},
        {"name": "when", "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "nums", "type": ["int", "double", "string"]},
        {"name": "grid", "type": {"type": "array", "items": {"type": "map",
          "values": ["null", "boolean"]}}}]}""",
    "qa": """{"type": "record", "name": "Answer", "fields": [
        {"name": "question", "type": "string"}, {"name": "answer", "type": "string"},
        {"name": "n", "type": "long"}]}""",
    **{p: f'"{p}"' for p in ("null", "boolean", "int", "long", "float", "double",
                             "bytes", "string")},
}
CHARS = list("abcxyz 0129_-éü€中\n\"\\")


def draw(schema, rng, depth: int = 0):
    """A seeded datum for a (JAX) parsed schema."""
    t = schema.type
    if t == "null":
        return None
    if t == "boolean":
        return bool(rng.integers(2))
    if t == "int":
        return int(rng.integers(-2**31, 2**31))
    if t == "long":
        return int(rng.integers(-2**62, 2**62))
    if t == "float":
        return float(np.float32(rng.normal() * 100))
    if t == "double":
        return float(rng.normal() * 1e6)
    if t == "bytes":
        return rng.bytes(int(rng.integers(0, 6)))
    if t == "string":
        return "".join(rng.choice(CHARS, int(rng.integers(0, 8))))
    if t == "fixed":
        return rng.bytes(schema.size)
    if t == "enum":
        return str(rng.choice(schema.symbols))
    if t == "array":
        return [draw(schema.items, rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    if t == "map":
        return {f"k{i}": draw(schema.values, rng, depth + 1)
                for i in range(int(rng.integers(0, 4)))}
    if t == "union":
        # deep in a recursive schema, take the first branch (null)
        i = 0 if depth > 3 else int(rng.integers(len(schema.branches)))
        return draw(schema.branches[i], rng, depth + 1)
    if t == "record":
        return {name: draw(f, rng, depth + 1) for name, f, _ in schema.fields}
    raise AssertionError(t)


def both(text):
    return jax_avro.parse_schema(text), avro.parse_schema(text)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_canonical_and_fingerprint_equal_jax(name):
    js, ps = both(SCHEMAS[name])
    assert ps.canonical() == js.canonical()
    assert ps.fingerprint() == js.fingerprint()
    assert ps.type == js.type and ps.name == js.name


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_encode_decode_equal_jax(name):
    js, ps = both(SCHEMAS[name])
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(25):
        datum = draw(js, rng)
        data = jax_avro.encode(js, datum)
        assert avro.encode(ps, datum) == data
        assert avro.decode(ps, data) == jax_avro.decode(js, data) == datum
        as_json = jax_avro.datum_to_json(datum)
        assert avro.datum_to_json(datum) == as_json
        for strict in (False, True):
            assert avro.json_to_datum(ps, as_json, strict) == jax_avro.json_to_datum(
                js, as_json, strict)


def test_user_record_and_values_equal_jax():
    js, ps = both(USER_SCHEMA)
    assert avro.encode(ps, USER) == jax_avro.encode(js, USER)
    assert avro.AvroValue(ps, USER).encode() == jax_avro.AvroValue(js, USER).encode()
    user = dict(USER)
    del user["email"]  # the union's default (null) applies
    assert avro.encode(ps, user) == jax_avro.encode(js, user)
    assert avro.AvroValue(ps, USER) == avro.AvroValue(avro.parse_schema(SCHEMAS["user_doc"]),
                                                      USER)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    ("outer", {"inner": {}}),  # a missing field without a default
    ("user", [1]),  # not a dict
    ("user", {**USER, "kind": "GOLD"}),  # not a symbol
    ("user", {**USER, "digest": b"abc"}),  # fixed of the wrong size
    ("user", {**USER, "email": 3}),  # no union branch
    ("null", 1),
    ("int", "x"),
], ids=lambda c: f"{c[0]}-{str(c[1])[:12]}")
def test_encode_errors_equal_jax(case):
    name, datum = case
    js, ps = both(SCHEMAS[name])
    want = _error(lambda: jax_avro.encode(js, datum))
    assert want is not None
    assert _error(lambda: avro.encode(ps, datum)) == want


@pytest.mark.parametrize("text", [
    '{"type": "record", "name": "B", "fields": [{"name": "r", "type": "Missing"}]}',
    '{"type": "uuid"}',
    "7",
])
def test_parse_errors_equal_jax(text):
    want = _error(lambda: jax_avro.parse_schema(text))
    assert want is not None
    assert _error(lambda: avro.parse_schema(text)) == want


def test_decode_errors_equal_jax():
    js, ps = both(USER_SCHEMA)
    data = jax_avro.encode(js, USER)[:-3]
    want = _error(lambda: jax_avro.decode(js, data))
    assert want is not None and _error(lambda: avro.decode(ps, data)) == want


def _out(record):
    value = record.value
    if type(value).__name__ == "AvroValue":
        return ("avro", value.schema.canonical(), value.data)
    return ("plain", value)


EDITS = {
    "fits": [("set", "value.age", 37), ("set", "value.tags", ["z"])],
    "added_field": [("set", "value.extra", "kept")],
    "dropped_field": [("drop", "value.score", None)],
    "both": [("set", "value.brand_new_field", "x"), ("drop", "value.age", None)],
    "key_and_value": [("set", "value.email", None), ("set", "key.name", "bob")],
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_mutable_avro_edits_equal_jax(edit):
    js, ps = both(USER_SCHEMA)
    outs = []
    for mutable, record, schema, value in ((JaxMutable, JaxRecord, js, jax_avro.AvroValue),
                                           (MutableRecord, SimpleRecord, ps, avro.AvroValue)):
        m = mutable.from_record(record.of(value(schema, dict(USER)),
                                          key=value(schema, dict(USER)), timestamp=1.0))
        assert m.get_field("value.blob") == "\x00ÿ"  # the JSON-compatible datum
        for op, path, val in EDITS[edit]:
            m.set_field(path, val) if op == "set" else m.drop_field(path)
        out = m.to_record()
        outs.append((_out(out), _out(record.of(out.key))))
    assert outs[1] == outs[0]
    if edit == "fits":
        assert outs[1][0][0] == "avro" and outs[1][0][2]["age"] == 37


def test_mutable_avro_refusal_equals_jax():
    """An edit whose value no longer encodes under the field's type raises
    what the JAX package raises."""
    js, ps = both(USER_SCHEMA)
    errors = []
    for mutable, record, schema, value in ((JaxMutable, JaxRecord, js, jax_avro.AvroValue),
                                           (MutableRecord, SimpleRecord, ps, avro.AvroValue)):
        m = mutable.from_record(record.of(value(schema, dict(USER))))
        m.set_field("value.age", "not a number")
        errors.append(_error(m.to_record))
    assert errors[0] is not None and errors[1] == errors[0]


def test_compute_step_over_avro_equals_jax():
    """``compute`` edits a field of an Avro record: the result stays an Avro
    value of the same schema, as in the JAX package."""
    config = {"fields": [{"name": "value.n", "expression": "value.n + 100", "type": "INT64"},
                         {"name": "value.answer", "expression": "fn:uppercase(value.answer)"}]}
    outs = []
    for toolkit, record, parse, value in ((JaxToolKit, JaxRecord, jax_avro.parse_schema,
                                           jax_avro.AvroValue),
                                          (GenAIToolKitAgent, SimpleRecord, avro.parse_schema,
                                           avro.AvroValue)):
        schema = parse(SCHEMAS["qa"])
        agent = toolkit("compute")
        asyncio.run(agent.init(config))
        records = [record.of(value(schema, {"question": f"q{i}", "answer": f"a{i}", "n": i}),
                             timestamp=1.0) for i in range(3)]
        results = asyncio.run(agent.process(records))
        outs.append([(r.error, [_out(o) for o in r.records]) for r in results])
    assert outs[1] == outs[0]
    assert outs[1][2][1][0] == ("avro", avro.parse_schema(SCHEMAS["qa"]).canonical(),
                                {"question": "q2", "answer": "A2", "n": 102})


def test_avro_values_cross_json_unchanged():
    """A value the Avro path does not own (a plain JSON document) still
    round-trips as JSON through ``MutableRecord``, as in the JAX package."""
    doc = json.dumps({"a": 1, "b": [1, 2]})
    outs = []
    for mutable, record in ((JaxMutable, JaxRecord), (MutableRecord, SimpleRecord)):
        m = mutable.from_record(record.of(doc))
        m.set_field("value.c", 3)
        outs.append(m.to_record().value)
    assert outs[1] == outs[0] == json.dumps({"a": 1, "b": [1, 2], "c": 3})
