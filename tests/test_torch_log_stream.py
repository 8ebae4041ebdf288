"""The port's live log hub (``runtime/log_stream.py``) against the JAX
package's: the same emits give the same entries (timestamps aside), a
record logged on a foreign thread reaches a live subscriber, the follow
stream's dedupe of an out-of-order history (in ``test_torch_webservice.py``,
beside the other follow cases), another app's records stay out of a hub,
the logger's level comes back after the last hub is removed, and a
stopped application ends its followers' streams."""

import asyncio
import logging
import threading

import pytest

from langstream_tpu.runtime import log_stream as jax_ls
from langstream_tpu_torch.runtime import log_stream as port_ls


def drop_time(entries):
    return [{k: v for k, v in e.items() if k != "timestamp"} for e in entries]


def test_same_emits_give_jax_entries():
    async def scenario(mod):
        hub = mod.LogHub("app1", maxlen=4)
        hub.attach_loop(asyncio.get_running_loop())
        q = hub.subscribe()
        for i in range(6):
            hub.emit(f"agent-{i % 2}", "INFO" if i % 3 else "WARNING", f"line {i}")
        live = [q.get_nowait() for _ in range(q.qsize())]
        hub.unsubscribe(q)
        hub.emit("agent-0", "INFO", "after")
        return drop_time(hub.history()), drop_time(hub.history("agent-1")), drop_time(live)

    port = asyncio.run(scenario(port_ls))
    assert port == asyncio.run(scenario(jax_ls))
    assert [e["seq"] for e in port[0]] == [4, 5, 6, 7]


@pytest.mark.parametrize("mod", [jax_ls, port_ls], ids=["jax", "port"])
def test_handler_tags_and_filters_records(mod):
    """Records of the package's logger: tagged with the task's replica,
    another application's kept out, ambient ones delivered (tagged app);
    the handler formats ``name: message``."""
    root = "langstream_tpu_torch" if mod is port_ls else "langstream_tpu"
    logger = logging.getLogger(f"{root}.test")

    async def scenario():
        hub = mod.LogHub("app1")
        hub.attach_loop(asyncio.get_running_loop())
        handler = mod.install_hub(hub)
        try:
            async def in_task(app, replica, text):
                mod.current_app_replica.set((app, replica))
                logger.info(text)

            await asyncio.create_task(in_task("app1", "echo-0", "mine"))
            await asyncio.create_task(in_task("app2", "echo-0", "theirs"))
            logger.info("ambient")
            logger.debug("too quiet")
        finally:
            mod.remove_hub(handler)
        return [(e["replica"], e["level"], e["message"].split(": ", 1)[1])
                for e in hub.history()]

    assert asyncio.run(scenario()) == [("echo-0", "INFO", "mine"), ("app", "INFO", "ambient")]


def test_port_handler_entries_equal_jax():
    """One script of records through each package's handler: equal entries
    once the logger names are made the same."""

    def scenario(mod, root):
        async def go():
            hub = mod.LogHub("app1")
            hub.attach_loop(asyncio.get_running_loop())
            handler = mod.install_hub(hub)
            try:
                mod.current_app_replica.set(("app1", "step-0"))
                logging.getLogger(f"{root}.agents").info("hello %s", "world")
                logging.getLogger(f"{root}.serving").warning("careful")
            finally:
                mod.remove_hub(handler)
            return [{**e, "message": e["message"].replace(root, "ROOT")}
                    for e in drop_time(hub.history())]

        return asyncio.run(go())

    assert scenario(port_ls, "langstream_tpu_torch") == scenario(jax_ls, "langstream_tpu")


def test_foreign_thread_record_reaches_a_live_subscriber():
    """The engine thread and executor calls log off the serving loop: the
    entry crosses with call_soon_threadsafe and wakes the waiting get()."""

    async def scenario():
        hub = port_ls.LogHub("app1")
        hub.attach_loop(asyncio.get_running_loop())
        handler = port_ls.install_hub(hub)
        q = hub.subscribe()
        try:
            t = threading.Thread(target=lambda: logging.getLogger(
                "langstream_tpu_torch.serving.engine").info("from the engine thread"))
            t.start()
            entry = await asyncio.wait_for(q.get(), 5)
            t.join()
            await asyncio.get_running_loop().run_in_executor(
                None, hub.emit, "worker-0", "INFO", "from an executor")
            second = await asyncio.wait_for(q.get(), 5)
        finally:
            port_ls.remove_hub(handler)
        return entry, second

    entry, second = asyncio.run(scenario())
    assert entry["replica"] == "app" and entry["message"].endswith("from the engine thread")
    assert (second["replica"], second["message"], second["seq"]) == (
        "worker-0", "from an executor", 2)


@pytest.mark.parametrize("mod", [jax_ls, port_ls], ids=["jax", "port"])
def test_level_restored_after_the_last_hub(mod):
    name = "langstream_tpu_torch" if mod is port_ls else "langstream_tpu"
    logger = logging.getLogger(name)
    before = logger.level
    logger.setLevel(logging.WARNING)
    try:
        a = mod.install_hub(mod.LogHub("a"))
        b = mod.install_hub(mod.LogHub("b"))
        assert logger.level == logging.INFO
        mod.remove_hub(a)  # removed in install order: still INFO while b lives
        assert logger.level == logging.INFO
        mod.remove_hub(b)
        assert logger.level == logging.WARNING
    finally:
        logger.setLevel(before)


def test_bounded_queue_drops_the_oldest_like_jax():
    async def scenario(mod):
        hub = mod.LogHub("app1", maxlen=3)
        hub.attach_loop(asyncio.get_running_loop())
        q = hub.subscribe()
        for i in range(5):
            hub.emit("r-0", "INFO", f"m{i}")
        return [q.get_nowait()["message"] for _ in range(q.qsize())]

    assert asyncio.run(scenario(port_ls)) == asyncio.run(scenario(jax_ls)) == ["m2", "m3", "m4"]


def test_close_ends_every_follower():
    """A stopped application's hub hands its followers ``None`` after their
    last line, and a follower that subscribes later gets it at once."""

    async def scenario():
        hub = port_ls.LogHub("app1")
        hub.attach_loop(asyncio.get_running_loop())
        q = hub.subscribe()
        hub.emit("r-0", "INFO", "last")
        threading.Thread(target=hub.close).start()  # from another thread
        got = [await asyncio.wait_for(q.get(), 5), await asyncio.wait_for(q.get(), 5)]
        late = hub.subscribe()
        return got, late.get_nowait()

    (last, end), late = asyncio.run(scenario())
    assert last["message"] == "last" and end is None and late is None
