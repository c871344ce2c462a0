"""An in-process kvserver store on a free localhost port, of either
package's ``server`` module: the KV-tier tests of the port (on the CPU and
on the card) run their engines against it.  Not a test file; the tests
import ``kv_server`` from it."""

import asyncio
import contextlib
import threading


@contextlib.contextmanager
def kv_server(server_module, latency_s: float = 0.0):
    """An in-process store of ``server_module`` (either package's) on a
    free localhost port; yields (store, port)."""
    store = server_module.KVStore(capacity_bytes=64 << 20)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state = {}

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            state["server"] = await asyncio.start_server(
                lambda r, w: server_module.handle_client(store, r, w, latency_s=latency_s),
                "127.0.0.1", 0)
            state["port"] = state["server"].sockets[0].getsockname()[1]
            started.set()

        loop.run_until_complete(boot())
        loop.run_forever()
        loop.close()

    async def shutdown():
        state["server"].close()
        tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(5)
    try:
        yield store, state["port"]
    finally:
        asyncio.run_coroutine_threadsafe(shutdown(), loop).result(5)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)
        assert not thread.is_alive()
