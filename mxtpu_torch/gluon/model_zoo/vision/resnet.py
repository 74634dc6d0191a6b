"""ResNet V1/V2 Gluon blocks — the port of
``mxtpu/gluon/model_zoo/vision/resnet.py`` (reference
``python/mxnet/gluon/model_zoo/vision/resnet.py``; He et al.
1512.03385, 1603.05027).

V1: conv→bn→relu blocks with post-addition relu. V2: pre-activation
(bn→relu→conv). Same layer/channel schedules and parameter names as
the reference, so ``.params`` files cross between the packages.

``stem="s2d"`` swaps the 7×7/stride-2/pad-3 stem conv for
:class:`SpaceToDepthStem` — the exact space-to-depth rewrite of the
same conv. The stem block keeps the standard (channels, in, 7, 7)
weight under the same structural name (``features.0.weight``), so
checkpoints load unchanged across stems in both directions.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "SpaceToDepthStem",
           "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class SpaceToDepthStem(HybridBlock):
    """Exact space-to-depth rewrite of ``Conv2D(channels, 7, 2, 3,
    use_bias=False)``: 2×2 space-to-depth fattens the 3-channel input
    to 12 channels, then a 4×4/stride-1 conv reproduces the centered
    7×7/stride-2/pad-3 conv tap-for-tap.

    The weight parameter STAYS (channels, in_channels, 7, 7): the
    equivalent (channels, 4·in, 4, 4) kernel is derived in-forward by a
    linear permute+pad of the 7×7 tensor (negligible next to the conv),
    so standard-stem checkpoints load unchanged and gradients/
    trajectories match the standard stem exactly.

    Mapping (centered pad-3 convention):
    output o reads pixels 2o-3…2o+3 = blocks o-2…o+1 = window
    2o-4…2o+3, whose FIRST tap is phantom — so the 7-tap kernel
    zero-pads to 8 at the front, and the s2d input pads (2,1) per
    spatial axis."""

    def __init__(self, channels, in_channels=0, weight_initializer=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels, 7, 7),
                init=weight_initializer, allow_deferred_init=True)

    def infer_shape(self, x, *args):
        shape = list(self.weight.shape)
        shape[1] = x.shape[1]
        self.weight.shape = tuple(shape)
        self._in_channels = x.shape[1]

    def hybrid_forward(self, F, x, weight):
        xshape = getattr(x, "shape", None)
        if xshape is not None and len(xshape) == 4 and \
                all(isinstance(d, int) for d in xshape[2:]) and \
                (xshape[2] % 2 or xshape[3] % 2):
            raise ValueError(
                f"stem='s2d' needs even spatial dims, got "
                f"{tuple(xshape[2:])}; use the standard stem for "
                f"odd-sized inputs")
        # weight.shape is authoritative whether the param arrived via
        # deferred init (infer_shape) or load_parameters
        o, c = self._channels, self.weight.shape[1]
        w8 = F.pad(weight, mode="constant",
                   pad_width=(0, 0, 0, 0, 1, 0, 1, 0))
        w = F.reshape(w8, shape=(o, c, 4, 2, 4, 2))
        w = F.transpose(w, axes=(0, 3, 5, 1, 2, 4))
        w = F.reshape(w, shape=(o, 4 * c, 4, 4))
        y = F.space_to_depth(x, block_size=2)
        y = F.pad(y, mode="constant",
                  pad_width=(0, 0, 0, 0, 2, 1, 2, 1))
        return F.Convolution(y, w, None, no_bias=True, kernel=(4, 4),
                             stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                             num_filter=o, num_group=1, layout="NCHW")

    def __repr__(self):
        return (f"{self.__class__.__name__}({self.weight.shape}, "
                f"block=2)")


def _make_stem(channels, stem):
    if stem == "s2d":
        return SpaceToDepthStem(channels)
    if stem != "std":
        raise ValueError(f"stem must be 'std' or 's2d', got {stem!r}")
    return nn.Conv2D(channels, 7, 2, 3, use_bias=False)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1,
                                strides=stride))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stem="std", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(_make_stem(channels[0], stem))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stem="std", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(_make_stem(channels[0], stem))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """``stem="s2d"`` selects the space-to-depth stem
    (checkpoint-compatible with ``stem="std"`` in both directions)."""
    if pretrained:
        raise RuntimeError(
            "pretrained weights are not bundled; load a checkpoint with "
            "net.load_parameters() instead")
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
