"""Host C++ runtime of the port: the threaded RRD loader, the SMF parser, the
zstd decoder and the PNG scanline filters, each built with g++ at first use
(``_build.py``), not when this package is imported."""

from midi_vae_tpu_torch.data.sources import write_rrd  # noqa: F401
from midi_vae_tpu_torch.native.rrd import NativeDataset, NativeLoader  # noqa: F401
