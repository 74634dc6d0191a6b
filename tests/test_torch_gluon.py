"""Parity of the port's Gluon layers (``mxtpu_torch.gluon.nn``) with
``mxtpu.gluon.nn`` on the CPU: every layer of ``activations`` and
``basic_layers`` (``conv_layers``' are ``test_torch_gluon_conv.py``'s
cases of the same table), eager and hybridized, through the
three calls of ``torch_gluon_cases.check`` (two recorded train-mode
calls with ``backward``, then a predict call): outputs, input and
parameter gradients, parameters and BatchNorm's running statistics
(written back from the hybridized call as an aux output) against the
reference's, at its tolerance. A Dropout mask drawn under ``record()``
from ``mx.random.seed(0)``'s chain equals the reference's, eager and
hybridized (where each call draws its own key first).
"""
import numpy as np
import pytest
import torch

import torch_gluon_cases as gc

torch.set_num_threads(2)

rng = np.random.default_rng(21)
f32 = np.float32
X2 = rng.standard_normal((3, 4)).astype(f32)
X3 = rng.standard_normal((2, 3, 4)).astype(f32)
IMG = rng.standard_normal((2, 4, 5, 5)).astype(f32)
IMG1 = rng.standard_normal((2, 4, 7)).astype(f32)
IMG3 = rng.standard_normal((1, 2, 4, 4, 4)).astype(f32)
TOK = np.array([[1, 4, 9], [0, 2, 2]], f32)


def seq(mx, *layers, hybrid=True):
    net = (mx.gluon.nn.HybridSequential if hybrid
           else mx.gluon.nn.Sequential)(prefix="net_")
    with net.name_scope():
        net.add(*[layer(mx.gluon.nn) for layer in layers])
    return net


LAYERS = {
    "dense": (lambda mx: seq(mx, lambda nn: nn.Dense(5, activation="tanh")),
              [X2]),
    "dense_deferred_3d": (lambda mx: seq(
        mx, lambda nn: nn.Dense(5, flatten=False, use_bias=False),
        lambda nn: nn.Dense(2)), [X3]),
    "dropout": (lambda mx: seq(mx, lambda nn: nn.Dense(6),
                               lambda nn: nn.Dropout(0.5),
                               lambda nn: nn.Dense(3)), [X2]),
    "dropout_axes": (lambda mx: seq(mx, lambda nn: nn.Dropout(0.3,
                                                              axes=(1,))),
                     [X3]),
    "embedding": (lambda mx: seq(mx, lambda nn: nn.Embedding(10, 4),
                                 lambda nn: nn.Dense(3)), [TOK], ()),
    "batchnorm": (lambda mx: seq(mx, lambda nn: nn.Conv2D(3, 3,
                                                          use_bias=False),
                                 lambda nn: nn.BatchNorm()), [IMG]),
    "batchnorm_axis_noscale": (lambda mx: seq(
        mx, lambda nn: nn.BatchNorm(axis=-1, scale=False, momentum=0.7,
                                    epsilon=1e-3)), [X3]),
    "batchnorm_global_stats": (lambda mx: seq(
        mx, lambda nn: nn.BatchNorm(use_global_stats=True)), [IMG]),
    "instancenorm": (lambda mx: seq(mx, lambda nn: nn.InstanceNorm(
        scale=True)), [IMG]),
    "layernorm": (lambda mx: seq(mx, lambda nn: nn.LayerNorm()), [X3]),
    "groupnorm": (lambda mx: seq(mx, lambda nn: nn.GroupNorm(2)), [IMG]),
    "flatten_identity": (lambda mx: seq(mx, lambda nn: nn.Flatten(),
                                        lambda nn: nn.Identity()), [X3]),
    "lambda": (lambda mx: seq(mx, lambda nn: nn.Lambda("tanh"),
                              hybrid=False), [X2]),
    "hybrid_lambda": (lambda mx: seq(mx, lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2)), [X2]),
    "hybrid_concatenate": (lambda mx: _concat(mx, True), [X2]),
    "concatenate": (lambda mx: _concat(mx, False), [X2]),
    "sequential": (lambda mx: seq(mx, lambda nn: nn.Dense(4),
                                  lambda nn: nn.Activation("relu"),
                                  hybrid=False), [X2]),
    "activations": (lambda mx: seq(
        mx, lambda nn: nn.Activation("sigmoid"), lambda nn: nn.LeakyReLU(0.1),
        lambda nn: nn.ELU(0.5), lambda nn: nn.SELU(), lambda nn: nn.Swish(2.0),
        lambda nn: nn.GELU(), lambda nn: nn.Activation("softrelu")), [X2]),
    "prelu": (lambda mx: seq(mx, lambda nn: nn.PReLU()), [X2]),
    "conv1d": (lambda mx: seq(mx, lambda nn: nn.Conv1D(
        6, 3, strides=2, padding=1, groups=2, activation="relu")), [IMG1]),
    "conv2d": (lambda mx: seq(mx, lambda nn: nn.Conv2D(
        3, (3, 2), padding=(1, 0), dilation=(1, 2))), [IMG]),
    "conv3d": (lambda mx: seq(mx, lambda nn: nn.Conv3D(
        2, 2, strides=2, in_channels=2)), [IMG3]),
    "conv1d_transpose": (lambda mx: seq(mx, lambda nn: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1)), [IMG1]),
    "conv2d_transpose": (lambda mx: seq(mx, lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, groups=2, in_channels=4)), [IMG]),
    "conv3d_transpose": (lambda mx: seq(mx, lambda nn: nn.Conv3DTranspose(
        2, 2, strides=(1, 2, 2))), [IMG3]),
    "pool_max": (lambda mx: seq(mx, lambda nn: nn.MaxPool1D(3, 2, 1),
                                lambda nn: nn.Flatten()), [IMG1]),
    "pool_2d": (lambda mx: seq(mx, lambda nn: nn.MaxPool2D(3, 2, 1,
                                                           ceil_mode=True),
                               lambda nn: nn.AvgPool2D(2, 1, 1,
                                                       count_include_pad=False)),
                [IMG]),
    "pool_3d": (lambda mx: seq(mx, lambda nn: nn.AvgPool3D(2),
                               lambda nn: nn.MaxPool3D(1)), [IMG3]),
    "pool_avg1d": (lambda mx: seq(mx, lambda nn: nn.AvgPool1D(2, 1,
                                                              ceil_mode=True)),
                   [IMG1]),
    "pool_global": (lambda mx: _global(mx), [IMG]),
    "reflection_pad": (lambda mx: seq(mx, lambda nn: nn.ReflectionPad2D(1),
                                      lambda nn: nn.Conv2D(2, 3)), [IMG]),
}


def _concat(mx, hybrid):
    nn = mx.gluon.nn
    net = (nn.HybridConcatenate if hybrid else nn.Concatenate)(
        axis=1, prefix="cat_")
    with net.name_scope():
        net.add(nn.Dense(3), nn.Dense(2, activation="relu"))
    return net


def _global(mx):
    nn = mx.gluon.nn
    net = nn.HybridConcatenate(axis=1, prefix="g_")
    with net.name_scope():
        for cls in (nn.GlobalMaxPool2D, nn.GlobalAvgPool2D):
            net.add(cls())
    return net


CONV_LAYERS = sorted(n for n in LAYERS
                     if n.startswith(("conv", "pool", "reflection")))


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(set(LAYERS) - set(CONV_LAYERS)))
def test_layer_matches_mxtpu(name, hybrid):
    make, xs, *diff = LAYERS[name]
    gc.check(make, xs, diff[0] if diff else (0,), hybrid)


def test_batchnorm_running_stats_written_back():
    """The hybridized train call writes BatchNorm's running statistics
    back as the reference's aux outputs do: they moved from their
    initial 0 and 1 and equal the reference's (checked in ``check``)."""
    net = gc.check(LAYERS["batchnorm"][0], [IMG], hybrid=True)
    stats = {n: p.data().asnumpy() for n, p in net.collect_params().items()
             if "running" in n}
    assert len(stats) == 2
    assert all(np.abs(v - (0.0 if "mean" in n else 1.0)).max() > 1e-3
               for n, v in stats.items())
    assert net.captures == 0            # the CPU runs no CUDA graph
