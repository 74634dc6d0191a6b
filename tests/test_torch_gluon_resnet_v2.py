"""The port's model-zoo ``resnet18_v2`` (pre-activation blocks)
against ``mxtpu.gluon.model_zoo.vision``'s on the CPU: the protocol and
bounds of ``test_torch_gluon_resnet.py``."""
import torch

from test_torch_gluon_resnet import check

torch.set_num_threads(2)


def test_resnet18_v2_matches_mxtpu():
    check("resnet18_v2", "std")
