"""Host ms a request on the serving path: the dispatch call, and result()
less its readback's wait, from the benchmark's own clocks around both."""


def read(r):
    host = r.counters["host_s"]
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
