"""The bytes that the rANS wave decode of a grid decode needs, counted from
the work and not from any kernel's operands, so that the share reads the
same work whatever implements it (one kernel a wave, a fused chain, a
persistent decode).

For each decode batch, from the containers alone (parsed by the plain
reference) and the reference's schedule of their shape:
- each stream word read once, at its 2 bytes;
- each lane's state read once, at its 4 bytes (a 32-bit state);
- each image's and channel's decode tables read once: every context's
  cdf at 2 bytes an entry (its values are below 2**15) and its scale at
  a byte;
- each symbol's context id read at a byte (15 contexts), where the
  schedule does not fix the context, and each symbol written at 2 bytes
  (1024 symbols).
What a kernel of today moves besides (states read and written in every
wave, 4-byte ids and symbols, tables again in every wave) is not work:
it is what a better kernel would not move.
"""

import numpy as np

from portbench.reference import container, schedule
from portbench.reference.tables import ALPHABET_SIZE, CONTEXT_AMOUNT

WORD_BYTES = 2
STATE_BYTES = 4
CDF_BYTES = 2
SCALE_BYTES = 1
ID_BYTES = 1
SYMBOL_BYTES = 2


def symbols_and_ids(height: int, width: int, mode: str):
    """Symbols an image channel decodes, and those whose context is computed."""
    sched = schedule.get_schedule(height, width, mode=mode)
    return sched.num_symbols, int(np.count_nonzero(sched.sched_fbkt < 0))


def batch_bytes(blobs) -> int:
    """One decode batch: the containers decoded together."""
    total = 0
    for blob in blobs:
        ci = container.deserialize(blob)
        meta = ci.metadata
        streams = meta.num_channels
        k, ids = symbols_and_ids(meta.height, meta.width, ci.mode)
        total += (WORD_BYTES * int(np.asarray(ci.stream).shape[0])
                  + STATE_BYTES * streams * ci.num_lanes
                  + streams * CONTEXT_AMOUNT * (CDF_BYTES * (ALPHABET_SIZE + 1) + SCALE_BYTES)
                  + streams * (ID_BYTES * ids + SYMBOL_BYTES * k))
    return total


def bytes_needed(batches) -> int:
    """The profiled pass's decode batches (core.loop.Batch)."""
    return sum(batch_bytes(b.blobs) for b in batches)
