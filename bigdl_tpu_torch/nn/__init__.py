"""bigdl_tpu_torch.nn — the layers and criterions of the port."""
from .activations import (Abs, Clamp, ELU, Exp, HardShrink, HardTanh,
                          LeakyReLU, Log, LogSigmoid, LogSoftMax, Max, Mean,
                          Min, Power, PReLU, ReLU, ReLU6, RReLU, Sigmoid,
                          SoftMax, SoftMin, SoftPlus, SoftShrink, SoftSign,
                          Sqrt, Square, Sum, Tanh, TanhShrink, Threshold)
from .attention import MultiHeadAttention, rope_rotate
from .containers import (Bottle, Concat, ConcatTable, Echo, Identity,
                         MapTable, ParallelTable, Sequential)
from .conv import (SpatialConvolution, SpatialConvolutionMap,
                   SpatialDilatedConvolution, SpatialFullConvolution,
                   SpatialShareConvolution, TemporalConvolution,
                   VolumetricConvolution)
from .criterion import (AbsCriterion, AbstractCriterion, BCECriterion,
                        ClassNLLCriterion, ClassSimplexCriterion,
                        CosineDistanceCriterion, CosineEmbeddingCriterion,
                        CrossEntropyCriterion, DiceCoefficientCriterion,
                        DistKLDivCriterion, HingeEmbeddingCriterion, L1Cost,
                        L1HingeEmbeddingCriterion, MarginCriterion,
                        MarginRankingCriterion, MSECriterion, MultiCriterion,
                        MultiLabelMarginCriterion,
                        MultiLabelSoftMarginCriterion, MultiMarginCriterion,
                        ParallelCriterion, SmoothL1Criterion,
                        SmoothL1CriterionWithWeights, SoftmaxWithCriterion,
                        SoftMarginCriterion, TimeDistributedCriterion)
from .dropout import Dropout
from .graph import Graph, Input, Model, ModuleNode
from .initialization import (BilinearFiller, ConstInitMethod,
                             InitializationMethod, MsraFiller, Ones,
                             RandomNormal, RandomUniform, VariableFormat,
                             Xavier, Zeros)
from .linear import (Add, AddConstant, Bilinear, CAdd, CMul, Cosine,
                     Euclidean, Linear, LookupTable, MM, Mul, MulConstant, MV)
from .module import (AbstractModule, Container, TensorModule, load_module,
                     rng_scope)
from .normalization import (BatchNormalization, ImageNormalize, L1Penalty,
                            LayerNorm, Normalize, RMSNorm,
                            SpatialBatchNormalization,
                            SpatialContrastiveNormalization,
                            SpatialCrossMapLRN, SpatialDivisiveNormalization,
                            SpatialSubtractiveNormalization)
from .pooling import (RoiPooling, SpatialAveragePooling, SpatialMaxPooling,
                      VolumetricMaxPooling)
from .recurrent import (GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole,
                        LSTMPeephole, Recurrent, RnnCell, TimeDistributed)
from .shape_ops import (Contiguous, CosineDistance, DotProduct, FlattenTable,
                        GradientReversal, Index, InferReshape, JoinTable,
                        MaskedSelect, MixtureTable, Narrow, NarrowTable, Pack,
                        Padding, PairwiseDistance, Replicate, Reshape,
                        Reverse, Scale, Select, SelectTable,
                        SpatialZeroPadding, SplitTable, Squeeze, Transpose,
                        Unsqueeze, View)
from .table_ops import (CAddTable, CDivTable, CMaxTable, CMinTable,
                        CMulTable, CSubTable)
from .tf_ops import Const, Fill, Nms, Shape, SplitAndSelect, StrideSlice
from .tree import BinaryTreeLSTM, TensorTree, TreeLSTM
