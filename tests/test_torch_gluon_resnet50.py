"""The port's model-zoo ``resnet50_v1`` (bottleneck blocks) against
``mxtpu.gluon.model_zoo.vision``'s on the CPU, with the standard stem
(the space-to-depth stem is ``test_torch_gluon_resnet50_s2d.py``'s), by
the protocol and bounds of ``test_torch_gluon_resnet.py``.

Each residual body's last BatchNorm gamma starts at 0, the usual init
for deep ResNets. From the plain Xavier init the train-mode step is
ill-conditioned at this size: sixteen bottlenecks of batch statistics
over 8 values amplify rounding until a change of one ulp in one stem
weight moves the port's own train-mode loss past that bound, and its
second-step losses by order 1.
"""
import torch

from test_torch_gluon_resnet import check

torch.set_num_threads(2)


def test_resnet50_v1_matches_mxtpu():
    check("resnet50_v1", "std", zero_gamma=True)
