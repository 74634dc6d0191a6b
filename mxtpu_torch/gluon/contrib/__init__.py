"""gluon.contrib — the port of ``mxtpu/gluon/contrib`` (reference
``python/mxnet/gluon/contrib/``)."""
from . import nn
