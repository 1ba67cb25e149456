"""Roofline bytes, the card's published peaks, and the device time of one
operator product.

The bytes are counted from the configuration's matrix, not from the
port's containers, so they stay the same whatever format or kernel a
later change uses: every nonzero streams ``bytes_per_nnz`` once, x is
read once and y written once, 4 bytes an entry, K columns each.
"""

import time

# Published peaks by the name torch.cuda.get_device_name reports (NVIDIA's
# data sheet, H100 SXM at its 700 W limit): device-memory bytes a second.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes": 3.35e12}}

# larger than the 50 MB L2: writing it between two products evicts the
# matrix, so each product reads it cold, as inside a solver iteration
# whose vector passes evict it
FLUSH_BYTES = 128 << 20
SLEEP_HZ = 2e9      # above the card's SM clock: a sleep of n cycles lasts
                    # at least n / SLEEP_HZ seconds
CALLS = 40          # products timed, each with its own pair of events


def product_bytes(cfg, k):
    """Bytes one product ``A @ X`` of an (n, k) block must move."""
    return (int(cfg["nnz"]) * int(cfg["bytes_per_nnz"])
            + (int(cfg["rows"]) + int(cfg["rows"])) * 4 * int(k))


def bound_ms(cfg, k, device_name):
    """The least time of that product at the card's published bandwidth,
    or None for a card without a published peak here."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return 1e3 * product_bytes(cfg, k) / peak["bytes"]


def product_ms(fn, inputs, torch):
    """Mean device ms of ``fn(x)``, the inputs taken in turn, with the L2
    flushed before each call.  A sleep kernel holds the stream while the
    host enqueues every call (a product's wrapper can take longer on the
    host than its kernel on the card); the timing counts only if the card
    had not reached the first call when the last was enqueued, else it is
    retried with a longer sleep."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=inputs[0].device)
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.zero_()
    fn(inputs[0])
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * CALLS * enqueue * SLEEP_HZ) + 1000000
    for _ in range(4):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(CALLS)]
        torch.cuda._sleep(cycles)
        for i, (start, end) in enumerate(pairs):
            flush.zero_()
            start.record()
            fn(inputs[i % len(inputs)])
            end.record()
        held = not pairs[0][0].query()
        torch.cuda.synchronize()
        if held:
            return sum(s.elapsed_time(e) for s, e in pairs) / CALLS
        cycles *= 4
    raise RuntimeError("the host could not enqueue %d products ahead of "
                       "the card" % CALLS)
