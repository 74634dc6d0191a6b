"""The port's vision model zoo against ``mxtpu``'s (reference
``tests/test_model_zoo.py``): ``get_model`` serves every name the
reference serves with the same parameters (names and shapes), and every
family computes the reference's logits on the same weights within 1e-5
of the largest logit (float32 convolutions summed in another order).

The weights are numpy draws from one seed (He-scaled normals; BatchNorm
statistics near their resting values), loaded into both packages by
name: neither initializer runs, so the reference compiles one program
per net (its initializers compile one per parameter shape) and VGG's
4096-wide layers cost no Threefry draws in the port. Each family runs
at the smallest input its pooling admits; DenseNet and Inception, whose
final pooling is fixed, at full size under the reference's ``slow``
mark (about 20 s each in a loaded suite)."""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.gluon.model_zoo import vision as jvision
from mxtpu_torch.gluon.model_zoo import vision as tvision

torch.set_num_threads(2)

NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
         "densenet121", "densenet161", "densenet169", "densenet201",
         "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
         "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
         "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
         "mobilenetv2_0.25"]


def test_every_reference_name_builds_the_same_parameters():
    for name in NAMES:
        mine = tvision.get_model(name, classes=7, prefix="z_")
        ref = jvision.get_model(name, classes=7, prefix="z_")
        got = [(k, p.shape) for k, p in mine.collect_params().items()]
        want = [(k, p.shape) for k, p in ref.collect_params().items()]
        assert got == want, name
    with pytest.raises(ValueError):
        tvision.get_model("resnet1000_v9")


def weights(shapes, seed=0):
    """Seeded numpy values for ``[(name, shape)]``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes:
        if name.endswith(("gamma", "running_var")):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = v.astype(np.float32)
    return out


def check(name, size):
    """The port's logits (eager, then two hybridized calls: the first
    runs eagerly, the second is the cached program) against the
    hybridized reference's, on the same weights."""
    x = np.random.default_rng(1).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    net = tvision.get_model(name, classes=10, prefix="z_")
    for p in net.collect_params().values():
        p.initialize(tmx.init.Zero(), ctx="cpu")   # resolves the shapes
    xs = tmx.nd.array(x, ctx="cpu")
    net(xs)
    w = weights([(k, p.shape) for k, p in net.collect_params().items()])
    net.collect_params().load_dict(w, ctx="cpu")
    got = [net(xs).asnumpy()]
    net.hybridize()
    got += [net(xs).asnumpy() for _ in range(2)]

    ref = jvision.get_model(name, classes=10, prefix="z_")
    params = ref.collect_params()
    assert sorted(params.keys()) == sorted(w), name
    for k, p in params.items():
        p._load_init(jmx.nd.array(w[k], ctx=jmx.cpu()), jmx.cpu())
    ref.hybridize()
    want = ref(jmx.nd.array(x, ctx=jmx.cpu())).asnumpy()
    assert np.abs(want).max() > 0.01, name
    for g in got:
        assert g.shape == (2, 10), (name, g.shape)
        np.testing.assert_allclose(g, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("name,size", [
    ("alexnet", 64), ("vgg11", 32), ("vgg13_bn", 32), ("vgg16", 32),
    ("vgg19_bn", 32), ("squeezenet1.0", 64), ("squeezenet1.1", 32),
    ("mobilenet0.25", 32), ("mobilenetv2_0.25", 32), ("resnet18_v2", 32),
    pytest.param("densenet121", 224, marks=pytest.mark.slow),
    pytest.param("inceptionv3", 299, marks=pytest.mark.slow)])
def test_logits_match_mxtpu(name, size):
    check(name, size)
