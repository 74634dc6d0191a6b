"""The port's model families, each the counterpart of ``mxtpu.models``'s
module of the same name: plain functions over ``mxtpu``'s parameter
trees plus an ``nn.Module`` façade."""
from . import bert, llama, resnet
from .bert import BertConfig
from .llama import LlamaConfig
from .resnet import ResNetConfig

__all__ = ["bert", "llama", "resnet", "BertConfig", "LlamaConfig",
           "ResNetConfig"]
