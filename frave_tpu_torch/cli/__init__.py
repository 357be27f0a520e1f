"""The port's command-line interface (frave_tpu/cli's counterpart):
``python -m frave_tpu_torch.cli {encode,decode,bench,optimize}``.

Images are ``.npy`` files ([h, w] or [h, w, 1|3] uint8, read and written
with numpy), or PNG, BMP, JPEG and GIF files where PIL imports."""

from .main import main

__all__ = ["main"]
