"""The port's model-zoo ``resnet50_v1`` with the space-to-depth stem
against ``mxtpu.gluon.model_zoo.vision``'s on the CPU: the protocol,
init and bounds of ``test_torch_gluon_resnet50.py``."""
import torch

from test_torch_gluon_resnet import check

torch.set_num_threads(2)


def test_resnet50_v1_s2d_matches_mxtpu():
    check("resnet50_v1", "s2d", zero_gamma=True)
