"""Core layers — the port of ``mxtpu/gluon/nn/basic_layers.py``
(reference ``python/mxnet/gluon/nn/basic_layers.py``).

Deferred shape inference: layers declare unknown input dims as 0 and
implement ``infer_shape``, each stating its rule (the reference MXNet
resolves it through symbolic infer-shape passes); shapes resolve on the
first forward. BatchNorm updates its running statistics on every
training-mode forward; in a hybridized call the update is an aux output
written back after the call.
"""
from __future__ import annotations

from typing import Optional

from ... import autograd
from ... import ndarray as nd
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "HybridConcatenate", "Concatenate",
           "Identity"]


class Sequential(Block):
    """Stack of blocks executed sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = self.__class__(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Stack of hybridizable blocks executed sequentially."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        # containers have no own params to bind; just chain children
        for block in self._children.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x):
        return self.forward(x)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())
        if isinstance(key, slice):
            net = self.__class__(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully connected layer: ``y = act(x·Wᵀ + b)`` (reference
    ``gluon.nn.Dense`` over src/operator/nn/fully_connected.cc)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._in_units = in_units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_units = int(x.size // x.shape[0]) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None, act=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape[1] else None} -> {shape[0]}, "
                f"{'linear' if self.act is None else self.act._act_type})")


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """Index → dense vector lookup (reference ``gluon.nn.Embedding``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class BatchNorm(HybridBlock):
    """Batch normalization with running-stat state (reference
    ``gluon.nn.BatchNorm`` over src/operator/nn/batch_norm.cc).

    Running stats update on every training-mode forward:
    ``moving = moving*momentum + batch*(1-momentum)`` — identical to the
    reference. Under hybridize the update travels as an aux output of the
    cached call."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and not self._use_global_stats
        if training:
            ax = self._axis % x.ndim
            red = tuple(i for i in range(x.ndim) if i != ax)
            batch_mean = x.astype("float32").mean(axis=red)
            batch_var = ((x.astype("float32") -
                          _expand(batch_mean, x.ndim, self._axis)) ** 2
                         ).mean(axis=red)
            with autograd.pause():
                m = self._momentum
                self.running_mean.set_data(
                    running_mean * m + batch_mean.detach() * (1 - m))
                self.running_var.set_data(
                    running_var * m + batch_var.detach() * (1 - m))
            # normalize with the stats just computed (use_global_stats
            # makes the op consume them as-is) instead of letting the op
            # reduce over x a second time; grads flow through the batch
            # stats as true batch-norm gradients require
            return F.BatchNorm(x, gamma, beta, batch_mean, batch_var,
                               eps=self._epsilon, momentum=self._momentum,
                               fix_gamma=not self._scale,
                               use_global_stats=True, axis=self._axis)
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}, "
                f"in_channels={self.gamma.shape[0]})")


def _expand(stat, ndim, axis):
    shape = [1] * ndim
    shape[axis] = -1
    return stat.reshape(tuple(shape))


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalization (reference ``gluon.nn.GroupNorm``, 1.6+)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        g = self._num_groups
        n, c = x.shape[0], x.shape[1]
        spatial = x.shape[2:]
        y = x.reshape(n, g, -1)
        mean = y.mean(axis=2, keepdims=True)
        var = ((y - mean) ** 2).mean(axis=2, keepdims=True)
        y = (y - mean) / ((var + self._epsilon).sqrt())
        y = y.reshape((n, c) + spatial)
        bshape = (1, c) + (1,) * len(spatial)
        return y * gamma.reshape(bshape) + beta.reshape(bshape)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[self._axis],)
        self.beta.shape = (x.shape[self._axis],)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return x.flatten()

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class Lambda(Block):
    """Wrap an arbitrary function as a Block (reference ``nn.Lambda``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = getattr(nd, function)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def forward(self, *args):
        return self._func(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fname = function
            self._func = lambda F, *a: getattr(F, fname)(*a)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"


class HybridConcatenate(HybridBlock):
    """Run children on the same input and concat outputs (``nn.HybridConcurrent``)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Concatenate(Block):
    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)
