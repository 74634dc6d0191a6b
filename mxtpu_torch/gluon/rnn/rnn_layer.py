"""Fused recurrent layers — the port of ``mxtpu/gluon/rnn/rnn_layer.py``
(reference ``python/mxnet/gluon/rnn/rnn_layer.py`` over
``src/operator/rnn.cc``).

Parameters are held per (layer, direction) as the reference holds them
(``l0_i2h_weight``, ``r0_h2h_bias``, ...) and packed into the ``RNN``
op's cuDNN-ordered vector at each forward, so checkpoints map name for
name; the op (``mx.nd.RNN``) runs each layer as a loop over time.
"""
from __future__ import annotations

from typing import List, Optional

from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"Invalid layout {layout}; must be TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        ng = self._gates
        with self.name_scope():
            for layer in range(num_layers):
                for dr, prefix in enumerate(
                        ["l", "r"][:self._dir]):
                    isz = input_size if layer == 0 \
                        else hidden_size * self._dir
                    pname = f"{prefix}{layer}"
                    for nm, shape, init in [
                            ("i2h_weight", (ng * hidden_size, isz),
                             i2h_weight_initializer),
                            ("h2h_weight", (ng * hidden_size, hidden_size),
                             h2h_weight_initializer),
                            ("i2h_bias", (ng * hidden_size,),
                             i2h_bias_initializer),
                            ("h2h_bias", (ng * hidden_size,),
                             h2h_bias_initializer)]:
                        p = self.params.get(
                            f"{pname}_{nm}", shape=shape, init=init,
                            dtype=dtype, allow_deferred_init=True)
                        # setattr registers in _reg_params via Block
                        setattr(self, f"{pname}_{nm}", p)

    @property
    def _gates(self) -> int:
        return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[self._mode]

    def _num_states(self) -> int:
        return 2 if self._mode == "lstm" else 1

    def state_info(self, batch_size: int = 0):
        info = [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append(dict(info[0]))
        return info

    def begin_state(self, batch_size: int = 0, func=nd.zeros, **kwargs):
        return [func(shape=i["shape"], **kwargs)
                for i in self.state_info(batch_size)]

    def infer_shape(self, x, *args):
        # only layer 0's i2h depends on the input feature dim (last axis
        # in both TNC and NTC layouts)
        isz = x.shape[-1]
        for prefix in ["l", "r"][:self._dir]:
            p = getattr(self, f"{prefix}0_i2h_weight")
            p.shape = (self._gates * self._hidden_size, isz)

    def __call__(self, inputs, states=None):
        # keep the no-states call unary so the cached-op signature stays
        # all-array (None is not a traceable leaf)
        if states is None:
            return super().__call__(inputs)
        return super().__call__(inputs, states)

    def forward(self, x, *args):
        states = args[0] if args else None
        # resolve deferred shapes from the input, then the standard path
        from ..parameter import DeferredInitializationError
        try:
            for p in self._reg_params.values():
                p.data()
        except DeferredInitializationError:
            self.infer_shape(x)
            for p in self._reg_params.values():
                p._finish_deferred_init()
        skip_states = states is None
        if skip_states:
            batch = x.shape[0] if self._layout == "NTC" else x.shape[1]
            states = self.begin_state(batch, ctx=x.context,
                                      dtype=x.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        params = {k: p.data() for k, p in self._reg_params.items()}
        out = self.hybrid_forward(nd, x, states, **params)
        if skip_states:
            return out[0]
        return out

    def _symbolic_call(self, *args):
        """Trace with Symbol inputs. Without explicit states, synthesize
        zero begin-states as ops on the data symbol (batch size flows from
        the input at bind time) and return only the sequence output —
        mirroring forward()'s state-less contract."""
        from ... import symbol as sym
        param_syms = {k: sym.var(p.name) for k, p in self._reg_params.items()}
        x = args[0]
        states = args[1] if len(args) > 1 else None
        skip_states = states is None
        if skip_states:
            xt = sym.swapaxes(x, dim1=0, dim2=1) if self._layout == "NTC" \
                else x
            n = self._num_layers * self._dir
            states = [sym._rnn_init_state(xt, num_states=n,
                                          state_size=self._hidden_size)]
            if self._mode == "lstm":
                states.append(sym._rnn_init_state(
                    xt, num_states=n, state_size=self._hidden_size))
        out = self.hybrid_forward(sym, x, states, **param_syms)
        return out[0] if skip_states else out

    def hybrid_forward(self, F, x, states, **params):
        if self._layout == "NTC":
            x = F.swapaxes(x, dim1=0, dim2=1)
        packed = self._pack_params(F, params)
        rnn_args = [x, packed, states[0]]
        if self._mode == "lstm":
            rnn_args.append(states[1])
        out = F.RNN(*rnn_args, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        outputs, out_states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, out_states

    def _pack_params(self, F, params):
        """cuDNN packing order: all weights (layer-major, l then r), then
        all biases — must match ops.rnn_param_layout."""
        parts = []
        for kinds in (("i2h_weight", "h2h_weight"),
                      ("i2h_bias", "h2h_bias")):
            for layer in range(self._num_layers):
                for prefix in ["l", "r"][:self._dir]:
                    for nm in kinds:
                        parts.append(F.reshape(
                            params[f"{prefix}{layer}_{nm}"], shape=(-1,)))
        return F.concat(*parts, dim=0)

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._input_size} -> "
                f"{self._hidden_size}, {self._layout}, "
                f"num_layers={self._num_layers}"
                + (", bidirectional" if self._dir == 2 else "") + ")")


class RNN(_RNNLayer):
    """Vanilla Elman RNN (tanh or relu) — reference ``gluon.rnn.RNN``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM — reference ``gluon.rnn.LSTM``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (cuDNN gate maths) — reference ``gluon.rnn.GRU``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
