"""Device ms a request in scoring and the top-n: what the serving block
launched outside its history gather and its fold-in (the score product,
biases, the history mask and ``torch.topk``)."""


def read(r):
    t = r.trace.device_s(span="serve_block")
    if t <= 0:
        return None
    return 1e3 * t / r.counters["requests"]
