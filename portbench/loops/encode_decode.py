"""One caller sends single-image requests: it encodes the next pool image
with encode() and then decodes that container with decode(), in a seeded
order that visits every image once a cycle. A closed loop with one client.

Reports encode_p95_ms and decode_p95_ms: the 95th percentile over every
encode request of the window (the call until the container bytes are on
the host) and over every decode request (until the pixels are).
"""

import time

import numpy as np

from portbench.core import stats
from portbench.core.loop import BaseLoop, Sample, latency_line, no_span

KEEP_SHARE = 0.25  # share of requests kept for the judge, drawn from the seed, and the first


class Loop(BaseLoop):
    ORDERED = True

    def reset(self):
        super().reset()
        self.enc_ms, self.dec_ms = [], []

    def unit(self, keep: bool = True, span=None):
        span = span or no_span
        F, prog = self.prog.F, self.prog
        (i,) = self.next_indices(1)
        self.attempted += 1
        try:
            t0 = time.perf_counter()
            with span("encode"):
                blob = F.encode(self.pool[i], prog.opts, device=prog.device)
            t1 = time.perf_counter()
            with span("decode"):
                out = F.decode(blob, device=prog.device).data
            t2 = time.perf_counter()
        except Exception:  # noqa: BLE001 -- a failed request is counted, the loop goes on
            self.fail(1)
            return
        self.enc_ms.append((t1 - t0) * 1e3)
        self.dec_ms.append((t2 - t1) * 1e3)
        self.done([i], [blob])
        if keep and (self.keep_rng.random() < KEEP_SHARE or not self.samples):
            self.samples.append(Sample(i, blob, np.array(out)))

    def values(self, window_s: float) -> dict:
        if not self.enc_ms:  # a window in which every request failed has no tail
            return self.bpp()
        return {**self.bpp(), "encode_p95_ms": stats.percentile(self.enc_ms, 95),
                "decode_p95_ms": stats.percentile(self.dec_ms, 95)}

    def latency_lines(self):
        return [latency_line(n, ms) for n, ms in (("encode", self.enc_ms), ("decode", self.dec_ms))
                if ms]
