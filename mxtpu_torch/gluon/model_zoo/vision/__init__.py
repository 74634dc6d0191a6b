"""Vision model zoo — the port of
``mxtpu/gluon/model_zoo/vision/__init__.py``: the ResNets, v1 and v2,
through the reference's ``get_model`` string registry. The zoo's other
nets (VGG, AlexNet, DenseNet, SqueezeNet, Inception, MobileNet) come
with ROADMAP Queue A item 10.3b: their names raise here."""
from .resnet import *           # noqa: F401,F403
from . import resnet as _resnet

LATER_SLICE = "comes with ROADMAP Queue A item 10.3b"
_LATER = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
          "vgg16_bn", "vgg19_bn", "alexnet", "densenet121", "densenet161",
          "densenet169", "densenet201", "squeezenet1.0", "squeezenet1.1",
          "inceptionv3", "mobilenet1.0", "mobilenet0.75", "mobilenet0.5",
          "mobilenet0.25", "mobilenetv2_1.0", "mobilenetv2_0.75",
          "mobilenetv2_0.5", "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Instantiate a model by name (reference ``vision.get_model``)."""
    models = {f"resnet{n}_v{v}": getattr(_resnet, f"resnet{n}_v{v}")
              for n in (18, 34, 50, 101, 152) for v in (1, 2)}
    name = name.lower()
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} {LATER_SLICE}")
    if name not in models:
        raise ValueError(
            f"Model {name!r} is not supported. Available: "
            f"{sorted(models)}")
    return models[name](**kwargs)


_LATER_FAMILIES = ("vgg", "alexnet", "densenet", "squeezenet", "inception",
                   "mobilenet", "get_vgg", "get_mobilenet")


def __getattr__(name):
    if name.lower().startswith(_LATER_FAMILIES):
        raise AttributeError(f"model_zoo.vision.{name} {LATER_SLICE}")
    raise AttributeError(
        f"module 'mxtpu_torch.gluon.model_zoo.vision' has no attribute "
        f"{name!r}")
