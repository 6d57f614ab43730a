"""bigdl_tpu_torch.dataset — in-memory datasets, samples and batching."""
from .dataset import (AbstractDataSet, LocalArrayDataSet, ShardedDataSet,
                      TransformedDataSet, array, rdd, sort_data)
from .sample import (MiniBatch, PaddingParam, Sample, SampleToBatch,
                     SampleToMiniBatch)
from .transformer import (ChainedTransformer, FnTransformer, Transformer,
                          transformer)
