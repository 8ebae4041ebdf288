"""Text-processing agents.

Parity: reference `langstream-agents-text-processing` (SURVEY §2.5):
`text-extractor` (Tika-based there; stdlib-based here: HTML through
``html.py``), `text-splitter`
(`TextSplitter.java` / `RecursiveCharacterTextSplitter.java` — a recursive
character splitter), `language-detector`, `text-normaliser`,
`document-to-json`. Each registers into the agent registry on import.
"""

from __future__ import annotations

import json
import re
import zipfile
from io import BytesIO
from typing import Any, Callable

from langstream_tpu_torch.agents.text.html import html_text
from langstream_tpu_torch.api.agent import ComponentType, SingleRecordProcessor
from langstream_tpu_torch.api.doc import ConfigModel, ConfigProperty, props
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.core.registry import REGISTRY, AgentTypeInfo

# ---------------------------------------------------------------------------
# text-splitter
# ---------------------------------------------------------------------------


def recursive_split(
    text: str,
    chunk_size: int,
    chunk_overlap: int,
    separators: list[str],
    length_function: Callable[[str], int],
    keep_separator: bool = False,
) -> list[str]:
    """Recursive character splitting (reference RecursiveCharacterTextSplitter,
    itself a port of the LangChain splitter): try the coarsest separator that
    appears in the text; splits still too large recurse on finer separators;
    small neighbouring splits merge back up to chunk_size with overlap."""

    def _split_on(text: str, separator: str) -> list[str]:
        if separator == "":
            return list(text)
        if keep_separator:
            parts = re.split(f"({re.escape(separator)})", text)
            # stitch separators onto the preceding fragment
            merged: list[str] = []
            for i in range(0, len(parts), 2):
                frag = parts[i]
                if i + 1 < len(parts):
                    frag += parts[i + 1]
                if frag:
                    merged.append(frag)
            return merged
        return [p for p in text.split(separator) if p != ""]

    def _merge(splits: list[str], separator: str) -> list[str]:
        joiner = "" if keep_separator else separator
        docs: list[str] = []
        current: list[str] = []
        total = 0
        for s in splits:
            slen = length_function(s)
            if current and total + slen + (len(joiner) if current else 0) > chunk_size:
                docs.append(joiner.join(current))
                # shed from the front until the carried overlap fits the
                # overlap budget AND leaves room for the incoming split
                while current and (
                    total > chunk_overlap
                    or total + slen + (len(joiner) if current else 0) > chunk_size
                ):
                    total -= length_function(current[0]) + (len(joiner) if len(current) > 1 else 0)
                    current.pop(0)

            current.append(s)
            total += slen + (len(joiner) if len(current) > 1 else 0)
        if current:
            docs.append(joiner.join(current))
        return [d for d in (doc.strip() for doc in docs) if d]

    def _split(text: str, separators: list[str]) -> list[str]:
        separator = separators[-1]
        rest: list[str] = []
        for i, sep in enumerate(separators):
            if sep == "" or sep in text:
                separator = sep
                rest = separators[i + 1 :]
                break
        splits = _split_on(text, separator)
        out: list[str] = []
        small: list[str] = []
        for s in splits:
            if length_function(s) < chunk_size:
                small.append(s)
            else:
                if small:
                    out.extend(_merge(small, separator))
                    small = []
                if rest:
                    out.extend(_split(s, rest))
                else:
                    out.append(s)
        if small:
            out.extend(_merge(small, separator))
        return out

    return _split(text, separators)


_TOKEN_ENCODINGS = {"cl100k_base", "p50k_base", "r50k_base", "o200k_base"}


def _token_length_function(encoding: str) -> Callable[[str], int]:
    """Token-count length function (the reference counts cl100k_base tokens via
    jtokkit; no tokenizer vocab ships in this image, so estimate ~4 chars/token
    — same scale, monotonic in text length). Unknown names are rejected so a
    typo doesn't silently change chunk sizes 4x."""
    if encoding not in _TOKEN_ENCODINGS:
        raise ValueError(
            f"unknown length_function {encoding!r}; use 'length' or one of "
            f"{sorted(_TOKEN_ENCODINGS)}"
        )
    return lambda s: max(1, len(s) // 4)


class TextSplitterAgent(SingleRecordProcessor):
    """`text-splitter` (reference TextSplitter.java): one record in, one
    record per chunk out, with chunk bookkeeping headers."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.splitter_type = configuration.get("splitter_type", "RecursiveCharacterTextSplitter")
        self.chunk_size = int(configuration.get("chunk_size", 200))
        self.chunk_overlap = int(configuration.get("chunk_overlap", 100))
        self.keep_separator = bool(configuration.get("keep_separator", False))
        self.separators = list(configuration.get("separators", ["\n\n", "\n", " ", ""]))
        lf = configuration.get("length_function", "length")
        if lf in ("length", "len"):
            self.length_function: Callable[[str], int] = len
        else:
            self.length_function = _token_length_function(lf)

    async def process_record(self, record: Record) -> list[Record]:
        text = record.value
        if isinstance(text, bytes):
            text = text.decode("utf-8", "replace")
        if not isinstance(text, str):
            text = str(text)
        chunks = recursive_split(
            text,
            self.chunk_size,
            self.chunk_overlap,
            self.separators,
            self.length_function,
            self.keep_separator,
        )
        out: list[Record] = []
        for i, chunk in enumerate(chunks):
            out.append(
                SimpleRecord.of(
                    chunk,
                    key=record.key,
                    headers=list(record.headers)
                    + [
                        ("chunk_id", str(i)),
                        ("chunk_num_chunks", str(len(chunks))),
                        ("chunk_text_length", str(self.length_function(chunk))),
                    ],
                    origin=record.origin,
                    timestamp=record.timestamp,
                )
            )
        self.processed(1)
        return out


# ---------------------------------------------------------------------------
# text-extractor
# ---------------------------------------------------------------------------


def _extract_docx(data: bytes) -> str:
    """OOXML word/document.xml text (stdlib replacement for Tika's docx path)."""
    from xml.etree import ElementTree

    with zipfile.ZipFile(BytesIO(data)) as zf:
        xml = zf.read("word/document.xml")
    ns = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    root = ElementTree.fromstring(xml)
    paragraphs = []
    for p in root.iter(f"{{{ns}}}p"):
        texts = [t.text or "" for t in p.iter(f"{{{ns}}}t")]
        if texts:
            paragraphs.append("".join(texts))
    return "\n".join(paragraphs)


def _extract_html(data: bytes | str) -> str:
    """The page's text, read on the stdlib (``html.html_text``: what the
    JAX package's bs4 reading gives)."""
    return html_text(data)


class TextExtractorAgent(SingleRecordProcessor):
    """`text-extractor` (reference uses Apache Tika; here: HTML via html.parser,
    docx via stdlib zip+xml, plain/UTF-8 text passthrough).
    Unsupported binary formats raise → routed to the errors policy."""

    async def process_record(self, record: Record) -> list[Record]:
        value = record.value
        text: str
        if isinstance(value, bytes):
            head = value[:512].lstrip()
            if value[:4] == b"PK\x03\x04":
                text = _extract_docx(value)
            elif head[:1] == b"<" or b"<html" in head.lower():
                text = _extract_html(value)
            elif value[:5] == b"%PDF-":
                raise ValueError("PDF extraction requires an external parser (not bundled)")
            else:
                text = value.decode("utf-8", "replace")
        elif isinstance(value, str):
            text = _extract_html(value) if value.lstrip().startswith("<") else value
        else:
            text = str(value)
        self.processed(1)
        return [SimpleRecord.copy_from(record, value=text)]


# ---------------------------------------------------------------------------
# language-detector
# ---------------------------------------------------------------------------

# Most-frequent function words per language — enough signal to classify the
# document-sized inputs this agent sees (the reference wraps the langdetect
# library; a library-free classifier keeps the image dependency-light).
_LANG_STOPWORDS: dict[str, frozenset[str]] = {
    "en": frozenset("the of and to in is you that it he was for on are as with his they at be this have from or had by but not what all were we when your can said there use an each which she do how their if will up other about out many then them these so some her would make like him into time has look two more".split()),
    "es": frozenset("de la que el en y a los del se las por un para con no una su al lo como más pero sus le ya o este sí porque esta entre cuando muy sin sobre también me hasta hay donde quien desde todo nos durante todos uno les ni contra otros ese eso ante ellos e esto".split()),
    "fr": frozenset("de la le et les des en un du une que est pour qui dans a par plus pas au sur ne se ce il sont avec son ils mais comme ou si leur y dont elle tout nous sa cette ses être aux cela était ont fait aussi".split()),
    "de": frozenset("der die und in den von zu das mit sich des auf für ist im dem nicht ein eine als auch es an werden aus er hat dass sie nach wird bei einer um am sind noch wie einem über einen so zum war haben nur oder aber vor zur bis mehr durch man".split()),
    "it": frozenset("di e il la che in a per è un non sono con si da come le dei io questo ha più ma lo della gli al se mi ci nel anche tu ti su una alla sua delle degli nella questa loro tutto molto".split()),
    "pt": frozenset("de a o que e do da em um para é com não uma os no se na por mais as dos como mas foi ao ele das tem à seu sua ou ser quando muito há nos já está eu também só pelo pela até isso".split()),
    "nl": frozenset("de en van het een in is dat op te zijn met die voor niet aan er om ook als dan maar bij of uit naar door over ze hij nog wordt wel geen worden deze tot hebben meer andere".split()),
}


def detect_language(text: str) -> str:
    words = re.findall(r"[\wÀ-ÿ]+", text.lower())
    if not words:
        return "unknown"
    best, best_score = "unknown", 0
    for lang, stops in _LANG_STOPWORDS.items():
        score = sum(1 for w in words if w in stops)
        if score > best_score:
            best, best_score = lang, score
    return best if best_score > 0 else "unknown"


class LanguageDetectorAgent(SingleRecordProcessor):
    """`language-detector`: annotate records with detected language; drop
    records outside `allowedLanguages` (reference behavior)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.allowed = set(configuration.get("allowedLanguages", []))
        self.property = configuration.get("property", "language")

    async def process_record(self, record: Record) -> list[Record]:
        value = record.value
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        lang = detect_language(str(value))
        self.processed(1)
        if self.allowed and lang not in self.allowed:
            return []
        headers = tuple(h for h in record.headers if h.key != self.property)
        out = SimpleRecord.copy_from(record, headers=headers).with_headers(
            [(self.property, lang)]
        )
        return [out]


# ---------------------------------------------------------------------------
# text-normaliser
# ---------------------------------------------------------------------------


class TextNormaliserAgent(SingleRecordProcessor):
    """`text-normaliser`: lowercase + whitespace-trim knobs."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.make_lowercase = bool(configuration.get("make-lowercase", True))
        self.trim_spaces = bool(configuration.get("trim-spaces", True))

    async def process_record(self, record: Record) -> list[Record]:
        text = record.value
        if isinstance(text, bytes):
            text = text.decode("utf-8", "replace")
        text = str(text)
        if self.make_lowercase:
            text = text.lower()
        if self.trim_spaces:
            text = re.sub(r"[ \t]+", " ", text)
            text = "\n".join(line.strip() for line in text.splitlines()).strip()
        self.processed(1)
        return [SimpleRecord.copy_from(record, value=text)]


# ---------------------------------------------------------------------------
# document-to-json
# ---------------------------------------------------------------------------


class DocumentToJsonAgent(SingleRecordProcessor):
    """`document-to-json`: wrap raw text into a JSON object under
    `text-field`, optionally copying record headers in as fields."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.text_field = configuration.get("text-field", "text")
        self.copy_properties = bool(configuration.get("copy-properties", True))

    async def process_record(self, record: Record) -> list[Record]:
        value = record.value
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        doc: dict[str, Any] = {}
        if self.copy_properties:
            for h in record.headers:
                doc[h.key] = h.value_as_string()
        doc[self.text_field] = value
        self.processed(1)
        return [SimpleRecord.copy_from(record, value=json.dumps(doc))]


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


def _register() -> None:
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="text-splitter",
            component_type=ComponentType.PROCESSOR,
            factory=TextSplitterAgent,
            composable=True,
            description="Split text into overlapping chunks (recursive character splitter).",
            config_model=ConfigModel(
                type="text-splitter",
                properties=props(
                    ConfigProperty("splitter_type", "splitter algorithm", default="RecursiveCharacterTextSplitter"),
                    ConfigProperty("chunk_size", "max chunk length", type="integer", default=200),
                    ConfigProperty("chunk_overlap", "overlap between chunks", type="integer", default=100),
                    ConfigProperty("keep_separator", "keep separators in chunks", type="boolean", default=False),
                    ConfigProperty("separators", "separator hierarchy", type="array"),
                    ConfigProperty("length_function", "length metric (length|cl100k_base)", default="length"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="text-extractor",
            component_type=ComponentType.PROCESSOR,
            factory=TextExtractorAgent,
            composable=True,
            description="Extract plain text from documents (HTML, docx, text).",
            config_model=ConfigModel(type="text-extractor", allow_unknown=True),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="language-detector",
            component_type=ComponentType.PROCESSOR,
            factory=LanguageDetectorAgent,
            composable=True,
            description="Detect document language; filter by allowed languages.",
            config_model=ConfigModel(
                type="language-detector",
                properties=props(
                    ConfigProperty("allowedLanguages", "keep only these languages", type="array"),
                    ConfigProperty("property", "header to set", default="language"),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="text-normaliser",
            component_type=ComponentType.PROCESSOR,
            factory=TextNormaliserAgent,
            composable=True,
            description="Lowercase and trim whitespace.",
            config_model=ConfigModel(
                type="text-normaliser",
                properties=props(
                    ConfigProperty("make-lowercase", "lowercase text", type="boolean", default=True),
                    ConfigProperty("trim-spaces", "collapse/trim whitespace", type="boolean", default=True),
                ),
            ),
        )
    )
    REGISTRY.register_agent(
        AgentTypeInfo(
            type="document-to-json",
            component_type=ComponentType.PROCESSOR,
            factory=DocumentToJsonAgent,
            composable=True,
            description="Wrap raw text into a JSON document.",
            config_model=ConfigModel(
                type="document-to-json",
                properties=props(
                    ConfigProperty("text-field", "field name for the text", default="text"),
                    ConfigProperty("copy-properties", "copy headers into the JSON", type="boolean", default=True),
                ),
            ),
        )
    )


_register()
