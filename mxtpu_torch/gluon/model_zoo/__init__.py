"""Model zoo — the port of ``mxtpu/gluon/model_zoo`` (reference
``python/mxnet/gluon/model_zoo/``): ``GluonLlama`` and the vision
ResNets."""
from . import vision
from .llama import GluonLlama
from .vision import get_model
