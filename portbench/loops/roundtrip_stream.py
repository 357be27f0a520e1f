"""One caller round-trips the pool again and again through
roundtrip_pipeline_torch_stream: a call takes batches_per_call batches of
batch_size pool images (the pool in order, cyclically) and returns their
containers and decoded images. A closed loop with one client.

Reports roundtrip_mp_s: the megapixels whose round trip completed in the
window, over the window.
"""

import time

import numpy as np

from portbench.core import stats
from portbench.core.loop import BaseLoop, Sample, latency_line, no_span

KEEP_PER_CALL = 4  # outputs of a call kept for the judge, drawn from the seed


class Loop(BaseLoop):
    def reset(self):
        super().reset()
        self.call_ms = []

    def unit(self, keep: bool = True, span=None):
        span = span or no_span
        tr = self.traffic
        idx = self.next_indices(tr["batch_size"] * tr["batches_per_call"])
        self.attempted += len(idx)
        try:
            t0 = time.perf_counter()
            with span("call"):
                blobs, outs = self.prog.F.roundtrip_pipeline_torch_stream(
                    [self.rasters[i] for i in idx], self.prog.opts,
                    batch_size=tr["batch_size"], device=self.prog.device, device_verify=False)
            self.call_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception:  # noqa: BLE001 -- a failed call is counted, the loop goes on
            self.fail(len(idx))
            return
        done = min(len(blobs), len(outs), len(idx))
        self.failed += len(idx) - done
        self.done(idx[:done], blobs[:done])
        if keep:
            for j in sorted(self.keep_rng.choice(len(idx), size=min(KEEP_PER_CALL, len(idx)),
                                                 replace=False)):
                out = np.array(outs[j].data) if j < len(outs) else None
                blob = blobs[j] if j < len(blobs) else b""
                self.samples.append(Sample(idx[j], blob, out))

    def values(self, window_s: float) -> dict:
        return {**self.bpp(), "roundtrip_mp_s": stats.rate(self.pixels / 1e6, window_s)}

    def latency_lines(self):
        return [latency_line("call", self.call_ms)] if self.call_ms else []
