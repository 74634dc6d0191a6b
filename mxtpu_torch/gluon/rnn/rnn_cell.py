"""Explicit recurrent cells — the port of ``mxtpu/gluon/rnn/rnn_cell.py``
(reference ``python/mxnet/gluon/rnn/rnn_cell.py``): single-step cells
and ``unroll``, and the structural wrappers (Sequential, Bidirectional,
Residual, Dropout, Zoneout).

Cell gate order matches the fused RNN op (cuDNN: LSTM i,f,g,o; GRU r,z,n)
so cell-built and fused-layer models interchange weights.
"""
from __future__ import annotations

from typing import List, Optional

from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


class RecurrentCell(HybridBlock):
    """Base: a single-step recurrence and a Python ``unroll`` (the
    reference's explicit-unroll path)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size: int = 0):
        raise NotImplementedError

    def begin_state(self, batch_size: int = 0, func=nd.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.pop("__layout__", None)
            states.append(func(**info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for ``length`` steps. ``inputs``: NDArray
        (batch, length, feat) for NTC, or list of (batch, feat)."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[0]
        else:
            batch = inputs.shape[layout.find("N")]
            seq = [x.squeeze(axis=axis) for x in
                   _split_seq(inputs, length, axis)]
        if begin_state is None:
            begin_state = self.begin_state(
                batch, ctx=seq[0].context, dtype=seq[0].dtype)
        states = begin_state
        outputs = []
        all_states = [] if valid_length is not None else None
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
            if all_states is not None:
                all_states.append(states)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            outputs = nd.SequenceMask(
                stacked, sequence_length=valid_length,
                use_sequence_length=True, axis=axis)
            # final states = the states at each sequence's OWN last valid
            # step, not the padded step T (reference: SequenceLast over the
            # per-step state stack)
            states = []
            for si in range(len(begin_state)):
                per_step = nd.stack(*[s[si] for s in all_states], axis=0)
                states.append(nd.SequenceLast(
                    per_step, sequence_length=valid_length,
                    use_sequence_length=True, axis=0))
            merge_outputs = True if merge_outputs is None else merge_outputs
            if not merge_outputs:
                outputs = [o.squeeze(axis=axis) for o in
                           _split_seq(outputs, length, axis)]
            return outputs, states
        if merge_outputs is None or merge_outputs:
            return nd.stack(*outputs, axis=axis), states
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        from ..parameter import DeferredInitializationError
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(inputs)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd, inputs, states, **params)

    def _symbolic_call(self, inputs, states):
        from ... import symbol as sym
        param_syms = {k: sym.var(p.name, aux=p.grad_req == "null")
                      for k, p in self._reg_params.items()}
        return self.hybrid_forward(sym, inputs, states, **param_syms)


def _split_seq(x, length, axis):
    return [x.slice_axis(axis=axis, begin=i, end=i + 1)
            for i in range(length)]


class _BaseRNNCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])


class RNNCell(_BaseRNNCell):
    """Elman cell: h' = act(W x + b + R h + b')."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        self._activation = activation
        super().__init__(hidden_size, **kwargs)

    @property
    def _gates(self):
        return 1

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseRNNCell):
    """LSTM cell, cuDNN gate order (i, f, g, o)."""

    @property
    def _gates(self):
        return 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        nh = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=nh * 4)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=nh * 4)
        gates = i2h + h2h
        sl = F.split(gates, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(sl[0])
        forget_gate = F.sigmoid(sl[1])
        in_transform = F.tanh(sl[2])
        out_gate = F.sigmoid(sl[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseRNNCell):
    """GRU cell, cuDNN gate order (r, z, n) with gated h2h for n."""

    @property
    def _gates(self):
        return 3

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        nh = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=nh * 3)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=nh * 3)
        i2h_sl = F.split(i2h, num_outputs=3, axis=-1)
        h2h_sl = F.split(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_sl[0] + h2h_sl[0])
        update_gate = F.sigmoid(i2h_sl[1] + h2h_sl[1])
        next_h_tmp = F.tanh(i2h_sl[2] + reset_gate * h2h_sl[2])
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells: output of one feeds the next (reference
    ``SequentialRNNCell``)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size: int = 0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[pos:pos + n]
            pos += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args):
        raise NotImplementedError

    def hybrid_forward(self, *args):
        raise NotImplementedError


HybridSequentialRNNCell = SequentialRNNCell


class _ModifierCell(RecurrentCell):
    """Base for cells wrapping another cell (reference ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size: int = 0, func=nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size,
                                           func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(RecurrentCell):
    """Applies dropout on the input sequence (reference DropoutCell)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """Zoneout: randomly keep previous state (Krueger et al. 2017;
    reference ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        self._counter += 1
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: nd.Dropout(like.ones_like(), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = next_output.zeros_like()
        from ... import autograd
        if autograd.is_training():
            if self.zoneout_outputs > 0:
                m = mask(self.zoneout_outputs, next_output)
                output = nd.where(m, next_output, prev_output)
            else:
                output = next_output
            if self.zoneout_states > 0:
                states = [nd.where(mask(self.zoneout_states, ns), ns, s)
                          for ns, s in zip(next_states, states)]
            else:
                states = next_states
        else:
            output, states = next_output, next_states
        self._prev_output = output
        return output, states

    def forward(self, *a):
        raise NotImplementedError

    def hybrid_forward(self, *a):
        raise NotImplementedError


class ResidualCell(_ModifierCell):
    """Adds the input to the cell output (reference ResidualCell)."""

    def __call__(self, inputs, states):
        self._counter += 1
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def forward(self, *a):
        raise NotImplementedError

    def hybrid_forward(self, *a):
        raise NotImplementedError


class BidirectionalCell(RecurrentCell):
    """Runs l_cell forward + r_cell backward over the sequence; outputs
    concatenated (reference BidirectionalCell; unroll-only)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll()")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size: int = 0, **kwargs):
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            batch = inputs.shape[layout.find("N")]
            seq = [x.squeeze(axis=axis) for x in
                   _split_seq(inputs, length, axis)]
        else:
            seq = list(inputs)
            batch = seq[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch, ctx=seq[0].context,
                                           dtype=seq[0].dtype)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(
            length, seq, begin_state[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is not None:
            # reverse each sequence within its valid length so the
            # backward pass starts at the true last step, not padding
            # (reference: SequenceReverse with sequence_length)
            stacked = nd.stack(*seq, axis=0)           # (T, N, C)
            rev = nd.SequenceReverse(stacked, sequence_length=valid_length,
                                     use_sequence_length=True)
            rseq = [rev.slice_axis(axis=0, begin=i, end=i + 1)
                    .squeeze(axis=0) for i in range(length)]
        else:
            rseq = list(reversed(seq))
        r_out, r_states = r_cell.unroll(
            length, rseq, begin_state[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is not None:
            rstacked = nd.stack(*r_out, axis=0)
            runrev = nd.SequenceReverse(
                rstacked, sequence_length=valid_length,
                use_sequence_length=True)
            r_out = [runrev.slice_axis(axis=0, begin=i, end=i + 1)
                     .squeeze(axis=0) for i in range(length)]
        else:
            r_out = list(reversed(r_out))
        outputs = [nd.concat(l, r, dim=1) for l, r in zip(l_out, r_out)]
        if merge_outputs is None or merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
