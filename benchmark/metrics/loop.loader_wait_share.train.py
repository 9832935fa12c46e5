"""loop.loader_wait_share.train: the share of the loop's window the main
thread spent waiting for its next batch from the (augmenting) loader, %:
sum of ``Trainer.clock.loader_ms`` over the window's batches / the
window."""


def read(r):
    waits = r.counters.get("loader_ms")
    if waits is None or not r.window_s:
        return None
    return 100.0 * sum(waits) / 1e3 / r.window_s
