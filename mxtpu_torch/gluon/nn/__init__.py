"""Neural-network layers — the port of ``mxtpu/gluon/nn`` (reference
``python/mxnet/gluon/nn/``)."""
from ..block import Block, HybridBlock
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
