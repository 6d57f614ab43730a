"""bigdl_tpu_torch.visualization — the crc32c checksum the serving
handoff seals its blobs with."""
from .crc32c import crc32c, masked_crc32c
