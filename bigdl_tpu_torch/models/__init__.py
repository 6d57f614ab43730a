"""bigdl_tpu_torch.models — the TransformerLM and its generator, ResNet
and LeNet-5."""
from .generate import cached_generate, make_generate
from .lenet import LeNet5
from .resnet import ResNet50, ResNetCifar, SpaceToDepthStem
from .transformer import TransformerBlock, TransformerLM
