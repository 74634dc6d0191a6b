"""Gluon recurrent layers and cells — the port of ``mxtpu/gluon/rnn``
(reference ``python/mxnet/gluon/rnn/``)."""
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, HybridSequentialRNNCell,
                       DropoutCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell)
from .rnn_layer import RNN, LSTM, GRU
