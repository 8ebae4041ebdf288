"""The port's ``webcrawler-source`` (stdlib ``urllib`` in a worker thread,
``html.parser`` links) against the JAX package's (aiohttp, bs4) over one
stdlib test site (``torch_rag_site.py``): the same records in the same
order (key, body bytes, the ``url`` / ``content_type`` / ``depth``
headers, origin), the same requests to the site in the same order (paths
and User-Agent), under robots.txt, allowed domains, forbidden paths,
``max-urls``, ``max-depth``, a 404, a redirect, a gzip page, a plain-text
document and a connection that drops (retried up to ``max-error-count``);
and the state file ``webcrawler.status.json`` resumed across the two
packages. Exact: nothing here is computed in floating point."""

import asyncio
import json
import shutil

import pytest
from torch_rag_site import Site, make_pages

from langstream_tpu.agents.web import WebCrawlerSource as JaxCrawler
from langstream_tpu_torch.agents.web import WebCrawlerSource as PortCrawler

CRAWLERS = {"jax": JaxCrawler, "port": PortCrawler}


@pytest.fixture(scope="module")
def site():
    s = Site(make_pages(seed=7, n=10))
    yield s
    s.close()


class _Ctx:
    def __init__(self, state_dir):
        self.state_dir = state_dir

    def get_persistent_state_directory(self):
        return self.state_dir


def _record(r):
    return (r.key, bytes(r.value), [(h.key, h.value) for h in r.headers], r.origin)


async def crawl(cls, config, state_dir, limit=None, commit_last=True):
    """Read until the frontier is empty (or ``limit`` records), committing
    each record as it comes (the last one only if ``commit_last``)."""
    agent = cls()
    await agent.init(config)
    agent.set_context(_Ctx(state_dir))
    await agent.start()
    out = []
    try:
        while limit is None or len(out) < limit:
            records = await agent.read()
            if not records:
                break
            out += records
            if commit_last or limit is None or len(out) < limit:
                await agent.commit(records)
    finally:
        await agent.close()
    return [_record(r) for r in out]


def _config(site, **extra):
    return {"seed-urls": [site.base + "/p0.html"], "allowed-domains": ["127.0.0.1"],
            "min-time-between-requests": 0, "max-error-count": 3, "http-timeout": 5000,
            "user-agent": "rag-test-crawler", **extra}


CASES = {
    "all": {},
    "max-urls": {"max-urls": 5},
    "max-depth": {"max-depth": 1},
    "no-robots-forbidden": {"handle-robots-file": False, "forbidden-paths": ["/p1", "/gz"]},
    "any-domain": {"allowed-domains": [], "max-urls": 14},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_crawl_equals_jax(site, tmp_path, case):
    config = _config(site, **CASES[case])
    out, logs = {}, {}
    for name, cls in CRAWLERS.items():
        state = tmp_path / name
        state.mkdir()
        del site.log[:]
        out[name] = asyncio.run(crawl(cls, config, state))
        logs[name] = list(site.log)
        saved = json.loads((state / "webcrawler.status.json").read_text())
        out[name + "-state"] = {k: saved[k] for k in ("pending", "visited", "emitted")}
    assert out["port"] == out["jax"]
    assert out["port-state"] == out["jax-state"]
    assert logs["port"] == logs["jax"]
    keys = [k for k, *_ in out["port"]]
    paths = {k.split(str(site.port), 1)[1] for k in keys}
    assert "/private/secret.html" not in paths or case == "no-robots-forbidden"
    assert "/missing.html" not in paths and "/flaky.html" not in paths
    if case == "all":
        # every reachable page, the redirect under its own url, the gzip
        # page decoded, the text document as text/plain; the flaky url
        # tried max-error-count times (each sent twice: a connection that
        # drops before the answer is tried once more), robots.txt once
        assert paths == {f"/p{i}.html" for i in range(10)} | {"/redirect", "/gz.html",
                                                              "/doc.txt"}
        by_key = {k: (v, dict(h)) for k, v, h, _ in out["port"]}
        assert by_key[site.base + "/gz.html"][0] == site.page("/gz.html")
        assert by_key[site.base + "/redirect"][0] == site.page("/p3.html")
        assert by_key[site.base + "/doc.txt"][1]["content_type"] == "text/plain"
        assert by_key[site.base + "/p0.html"][1] == {
            "url": site.base + "/p0.html", "content_type": "text/html", "depth": "0"}
        assert [p for p, _ in logs["port"]].count("/flaky.html") == 2 * 3
        assert [p for p, _ in logs["port"]].count("/robots.txt") == 1
        assert {ua for _, ua in logs["port"]} == {"rag-test-crawler"}
    if case == "max-urls":
        # the 404 counts toward the budget: it is visited
        assert len(out["port-state"]["visited"]) == 5 > len(keys)
    if case == "any-domain":
        assert any(k.startswith(f"http://localhost:{site.port}/") for k in keys)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_state_resumes_across_packages(site, tmp_path, first, second):
    """One package crawls 4 pages and commits 3 (the 4th stays emitted),
    then stops; the other resumes from its state file and must emit what
    the first package emits resuming from the same file."""
    config = _config(site)
    head = tmp_path / "head"
    head.mkdir()
    asyncio.run(crawl(CRAWLERS[first], config, head, limit=4, commit_last=False))
    saved = json.loads((head / "webcrawler.status.json").read_text())
    # three committed pages and the 404 visited, the fourth page emitted
    assert len(saved["visited"]) == 4 and len(saved["emitted"]) == 1
    rest = {}
    for name in (first, second):
        d = tmp_path / f"resume-{name}"
        shutil.copytree(head, d)
        rest[name] = asyncio.run(crawl(CRAWLERS[name], config, d))
    assert rest[second] == rest[first]
    # the uncommitted page comes again, at depth 0 (the state's rule)
    assert saved["emitted"][0] in [k for k, *_ in rest[second]]
