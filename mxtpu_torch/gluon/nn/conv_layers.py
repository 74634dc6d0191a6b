"""Convolution & pooling layers — the port of
``mxtpu/gluon/nn/conv_layers.py`` (reference
``python/mxnet/gluon/nn/conv_layers.py``). NCHW ("channels first")
layout like the reference; the ops are ``mx.nd.Convolution``,
``Deconvolution`` and ``Pooling`` (cuDNN on the card)."""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tuplify(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution",
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        ndim = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": _tuplify(strides, ndim),
            "dilate": _tuplify(dilation, ndim),
            "pad": _tuplify(padding, ndim), "num_filter": channels,
            "num_group": groups, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = _tuplify(adj, ndim)
        self._op_name = op_name
        if op_name == "Convolution":
            wshape = (channels, in_channels // groups
                      if in_channels else 0) + tuple(kernel_size)
        else:  # Deconvolution stores weight as (in, out//groups, ...)
            wshape = (in_channels, channels // groups) + tuple(kernel_size)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        in_channels = x.shape[1]
        shape = list(self.weight.shape)
        if self._op_name == "Convolution":
            shape[1] = in_channels // self._kwargs["num_group"]
            shape[0] = self._channels
        else:
            shape[0] = in_channels
        self.weight.shape = tuple(shape)
        self._in_channels = in_channels

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f"{self.__class__.__name__}({self.weight.shape}, "
                f"stride={self._kwargs['stride']})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 3), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 3), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=output_padding, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": _tuplify(strides, ndim),
            "pad": _tuplify(padding, ndim), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{self.__class__.__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplify(pool_size, 1), strides, padding,
                         ceil_mode, pool_type="max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplify(pool_size, 2), strides, padding,
                         ceil_mode, pool_type="max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tuplify(pool_size, 3), strides, padding,
                         ceil_mode, pool_type="max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tuplify(pool_size, 1), strides, padding,
                         ceil_mode, pool_type="avg",
                         count_include_pad=count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplify(pool_size, 2), strides, padding,
                         ceil_mode, pool_type="avg",
                         count_include_pad=count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tuplify(pool_size, 3), strides, padding,
                         ceil_mode, pool_type="avg",
                         count_include_pad=count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, ndim, pool_type, **kwargs):
        super().__init__((1,) * ndim, None, 0, global_pool=True,
                         pool_type=pool_type, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", **kwargs)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
