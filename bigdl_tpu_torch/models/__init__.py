"""bigdl_tpu_torch.models — the TransformerLM and its generator, ResNet,
LeNet-5, Inception v1/v2, VGG, the autoencoder and the recurrent
models."""
from .autoencoder import Autoencoder
from .generate import cached_generate, make_generate
from .inception import (Inception_v1, Inception_v2,
                        InceptionV1NoAuxClassifier,
                        InceptionV2NoAuxClassifier)
from .lenet import LeNet5, lenet_graph
from .resnet import ResNet50, ResNetCifar, SpaceToDepthStem
from .rnn import LSTMClassifier, SimpleRNN
from .transformer import TransformerBlock, TransformerLM
from .vgg import Vgg16, Vgg19, VggForCifar10
