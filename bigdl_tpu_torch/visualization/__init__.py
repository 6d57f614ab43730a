"""bigdl_tpu_torch.visualization — TensorBoard event files (train,
validation, serving and telemetry summaries) and the crc32c checksum
that frames them and seals checkpoints and the serving handoff."""
from .crc32c import crc32c, masked_crc32c
from .summary import (ServingSummary, Summary, TelemetrySummary,
                      TrainSummary, ValidationSummary, read_scalars)
from .writer import EventWriter, FileWriter, RecordWriter
