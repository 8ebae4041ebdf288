"""The port's HTML reading (``agents/text/html.py``, stdlib ``html.parser``)
against the JAX package's bs4 reading: ``text-extractor``'s
``_extract_html`` and ``webcrawler-source``'s ``_extract_links`` on the
same pages, string for string (no tolerance: nothing is computed in
floating point)."""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from langstream_tpu.agents.text import _extract_html as jax_text
from langstream_tpu.agents.web import WebCrawlerSource as JaxCrawler
from langstream_tpu_torch.agents.text import _extract_html as port_text
from langstream_tpu_torch.agents.text.html import html_links, html_text

BASE = "http://site.test/docs/page.html"


pytestmark = pytest.mark.filterwarnings("ignore::bs4.XMLParsedAsHTMLWarning")


def jax_links(base, body):
    return JaxCrawler._extract_links(None, base, body)


FIXTURES = {
    "everything": """<!DOCTYPE html>
<html><head><title>T &amp; t</title><style>p { color: red }</style>
<script>var a = "<p>not text</p>";</script></head>
<body><!-- a comment --><noscript><p>no script</p></noscript>
<h1>Head&nbsp;line</h1><p>One <b>bold <i>and italic</i></b> word&#33; &#x263A; &#150;</p>
<![CDATA[ kept cdata ]]><?php echo 1; ?>
<a href="/abs">abs</a> <a href="rel.html#frag">rel</a> <a href="#only">frag</a>
<a href="mailto:a@b.c">mail</a> <a href="https://other.test/x?y=1#z">other</a>
<a name="no-href">none</a><a href>empty</a><a HREF="first" href="second">dup</a>
<pre>  keep
   spaces  </pre><p>   </p>



<p>after blank lines</p></body></html>""",
    "malformed": """<div><p>unclosed <b>bold <i>italic</p> stray</i></span></div>
<ul><li>one<li>two</ul><br>after br</br>more<br/>x</br>y<img src=a.png alt=b>
<input disabled><a href=unquoted.html>unq</a><a href='single.html' class>sq</a>
<p>&unknown; &amp &lt;tag&gt; &#0; &#xD800; &#1114112; &#128; &#129;</p><div""",
    "containers": """<ruby>漢<rp>(</rp><rt>kan</rt><rp>)</rp></ruby>
<template><p>templ <a href="in-template.html">t</a></p><![CDATA[cd in template]]></template>
<noscript>ns <a href="in-noscript.html">n</a></noscript><textarea>  a
 b  </textarea><script>unclosed script <a href="x">""",
    "nested-drop": """<div><noscript><div><style>s</style>x</div>y</noscript>z</div>
<script>1</script><script>2</script>w<style></style>v""",
    "empty": "",
    "text-only": "just text, no tags &amp; a ref",
    "comment-at-end": "<p>a</p><!-- unterminated",
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_text_equals_bs4(name):
    page = FIXTURES[name]
    assert port_text(page) == jax_text(page)
    assert port_text(page.encode()) == jax_text(page.encode())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_links_equal_bs4(name):
    page = FIXTURES[name]
    got = html_links(BASE, page.encode())
    assert got == jax_links(BASE, page.encode())
    assert all(link.startswith(("http://", "https://")) and "#" not in link for link in got)


def test_fixture_readings():
    """What the fixtures are there to show, read off the port's output."""
    text = html_text(FIXTURES["everything"])
    assert "not text" not in text and "no script" not in text and "a comment" not in text
    assert "color" not in text and "php" not in text and "DOCTYPE" not in text
    assert "Head\xa0line" in text and "word!" in text and "☺" in text and "–" in text
    assert "kept cdata" in text and "  keep\n   spaces  " in text and "\n\n\n" not in text
    links = html_links(BASE, FIXTURES["everything"])
    assert links == ["http://site.test/abs", "http://site.test/docs/rel.html",
                     "http://site.test/docs/page.html", "https://other.test/x?y=1",
                     "http://site.test/docs/page.html", "http://site.test/docs/second"]
    assert html_text(FIXTURES["containers"]).split("\n")[0] == "漢"
    assert "in-template.html" in " ".join(html_links(BASE, FIXTURES["containers"]))


def test_encodings_equal_bs4(monkeypatch):
    """Bytes: a byte-order mark, a declared charset, UTF-8 and windows-1252
    decode as bs4 decodes them. bs4 consults a third-party charset guesser
    before UTF-8 when one is installed (charset_normalizer here); the port
    never guesses, so the windows-1252 page, which such a guesser reads
    otherwise, is held against bs4 with the guesser off."""
    import bs4.dammit

    body = "<p>café – naïve</p>"
    pages = [
        b"\xef\xbb\xbf" + body.encode(),
        b'<meta charset="latin-1">' + "<p>café</p>".encode("latin-1"),
        b'<?xml version="1.0" encoding="utf-8"?>' + body.encode(),
        body.encode("utf-16"),
        body.encode(),
    ]
    for page in pages:
        assert port_text(page) == jax_text(page)
    monkeypatch.setattr(bs4.dammit, "chardet_module", None)
    for page in pages + [b"<p>" + bytes(range(0x80, 0xa0)) + b"</p>",
                         "<p>café – naïve</p>".encode("cp1252")]:
        assert port_text(page) == jax_text(page)


_TAGS = ["p", "div", "b", "a", "br", "img", "pre", "script", "style", "noscript", "template",
         "rt", "textarea", "li", "span"]
_piece = st.one_of(
    st.sampled_from(_TAGS).map(lambda t: f"<{t}>"),
    st.sampled_from(_TAGS).map(lambda t: f"</{t}>"),
    st.sampled_from(_TAGS).map(lambda t: f"<{t}/>"),
    st.sampled_from(["#a", "x.html", "/y", "mailto:q", "https://o.test/z#f", ""]).map(
        lambda h: f'<a href="{h}">'),
    st.sampled_from(["&amp;", "&lt;", "&nbsp;", "&#65;", "&#x41;", "&#150;", "&bogus;", "&amp",
                     "<!-- c -->", "<![CDATA[ c ]]>", "<!DOCTYPE html>", "<?pi x?>", "\n\n\n",
                     "   ", "\t", "<", ">", "&"]),
    st.text(alphabet="ab \n.é", min_size=1, max_size=6),
)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_piece, max_size=30).map("".join))
def test_generated_documents_equal_bs4(page):
    assert port_text(page) == jax_text(page)
    assert html_links(BASE, page) == jax_links(BASE, page)
