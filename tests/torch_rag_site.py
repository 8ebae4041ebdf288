"""A small web site on the stdlib ``ThreadingHTTPServer`` (127.0.0.1, a free
port) for the crawler and RAG-app tests of the port: pages made from a
seed that link to each other, plus everything a crawl must handle — a
``robots.txt`` that disallows ``/private/``, a link that answers 404, a
link to another host (``localhost`` on the same port), fragment and
``mailto:`` links, a redirect, a gzip-encoded page, a plain-text document
and a path whose connection drops without an answer (a fetch error).
Every request's path and User-Agent are logged in order."""

from __future__ import annotations

import gzip
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

WORDS = ("tensor core stream record topic agent pipeline vector index query answer "
         "memory cache page kernel batch token embed chunk crawl site").split()


def make_pages(seed: int, n: int, words_per_page: int = 60) -> dict[str, str]:
    """``/p0.html`` .. ``/p{n-1}.html``: a few paragraphs of seeded words
    each, linking to the next two pages and to the hazards."""
    rng = random.Random(seed)
    pages = {}
    for i in range(n):
        paras = []
        for _ in range(3):
            paras.append(" ".join(rng.choice(WORDS) for _ in range(words_per_page // 3)))
        links = [f'<a href="/p{(i + 1) % n}.html">next</a>',
                 f'<a href="p{(i + 2) % n}.html#part">skip</a>']
        if i == 0:
            links += ['<a href="/private/secret.html">private</a>',
                      '<a href="/missing.html">missing</a>',
                      '<a href="http://localhost:{port}/p1.html">other host</a>',
                      '<a href="mailto:site@example.com">mail</a>', '<a href="#top">top</a>',
                      '<a href="/flaky.html">flaky</a>', '<a href="/redirect">moved</a>',
                      '<a href="/gz.html">gz</a>', '<a href="/doc.txt">doc</a>']
        body = "".join(f"<p>{p}</p>" for p in paras)
        pages[f"/p{i}.html"] = (
            f"<!DOCTYPE html><html><head><title>page {i}</title><style>p {{}}</style></head>"
            f"<body><h1>Page {i}</h1>{body}<nav>{' '.join(links)}</nav>"
            f"<script>var x = {i};</script></body></html>")
    pages["/private/secret.html"] = "<html><p>robots keep this out</p></html>"
    pages["/gz.html"] = '<html><p>compressed page</p><a href="/p2.html">p2</a></html>'
    pages["/doc.txt"] = "a plain text document"
    return pages


class Site:
    def __init__(self, pages: dict[str, str]) -> None:
        self.pages = pages
        self.log: list[tuple[str, str]] = []
        site = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                site.log.append((self.path, self.headers.get("User-Agent", "")))
                if self.path == "/robots.txt":
                    return self._send(200, "text/plain", b"User-agent: *\nDisallow: /private/\n")
                if self.path == "/flaky.html":
                    self.close_connection = True  # no answer at all
                    return
                if self.path == "/redirect":
                    self.send_response(302)
                    self.send_header("Location", "/p3.html")
                    self.send_header("Content-Length", "0")
                    return self.end_headers()
                body = site.pages.get(self.path)
                if body is None:
                    return self._send(404, "text/html", b"<html>not found</html>")
                data = body.replace("{port}", str(site.port)).encode()
                if self.path == "/gz.html":
                    return self._send(200, "text/html; charset=utf-8", gzip.compress(data),
                                      {"Content-Encoding": "gzip"})
                ctype = "text/plain" if self.path.endswith(".txt") else "text/html; charset=utf-8"
                self._send(200, ctype, data)

            def _send(self, status, ctype, data, extra=None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def page(self, path: str) -> bytes:
        return self.pages[path].replace("{port}", str(self.port)).encode()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join()
