"""The rANS wave decode's work arithmetic: counted by hand on a real
container, independent of how the batch is split, and never above what
the port's kernel checks count on the operands of a real decode (plain
versions on the CPU), which hold more than the work."""

import numpy as np
import pytest

from portbench.core import manifest as M
from portbench.core.loop import Batch
from portbench.core.pool import natural_image
from portbench.reference import container, schedule


def _blobs(shape, images):
    import frave_tpu_torch as F

    h, w, c = shape
    return [F.encode(natural_image(h, w, c, [3, i]), F.EncoderOptions(), device="cpu")
            for i in range(images)]


def test_bytes_by_hand():
    work = M.load_kernel_family("rans_decode")["work"]
    (blob,) = _blobs((64, 96, 3), 1)
    ci = container.deserialize(blob)
    sched = schedule.get_schedule(64, 96)
    k, ids = sched.num_symbols, int(np.count_nonzero(sched.sched_fbkt < 0))
    assert 0 < ids < k
    want = (2 * len(ci.stream) + 4 * 3 * ci.num_lanes + 3 * 15 * (2 * 1025 + 1)
            + 3 * (ids + 2 * k))
    assert work.bytes_needed([Batch([0], [blob])]) == want


@pytest.mark.parametrize("shape,images,batch", [((256, 256, 1), 2, 2), ((96, 160, 3), 3, 1)])
def test_work_within_the_kernel_checks_operand_count(monkeypatch, shape, images, batch):
    from frave_tpu_torch import kernel_check as KC
    from frave_tpu_torch.codec import grid_decode as GD
    from frave_tpu_torch.codec import pipeline_torch as P
    from frave_tpu_torch.codec.container import deserialize

    blobs = _blobs(shape, images)
    seen = []
    real = GD.decode_scan_wave

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(KC.bytes_moved("decode_scan_wave", args, out))
        return out

    monkeypatch.setattr(GD, "decode_scan_wave", spy)
    batches = [Batch(list(range(b0, min(b0 + batch, images))), blobs[b0:b0 + batch])
               for b0 in range(0, images, batch)]
    for b in batches:
        P.decode_pipeline_torch_batch([deserialize(x) for x in b.blobs], "cpu")
    work = M.load_kernel_family("rans_decode")["work"]
    need = work.bytes_needed(batches)
    assert need == work.bytes_needed([Batch(list(range(images)), blobs)])
    assert 0 < need < sum(seen)
