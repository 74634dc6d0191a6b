"""Parity of the port's convolution and pooling layers
(``mxtpu_torch.gluon.nn.conv_layers``: Conv1D/2D/3D, their transposes,
max/avg pooling in 1-3 dimensions with ``ceil_mode`` and
``count_include_pad``, the global pools and ReflectionPad2D) with
``mxtpu.gluon.nn`` on the CPU, eager and hybridized: the cases of
``test_torch_gluon.py``'s table run through ``torch_gluon_cases.check``."""
import pytest
import torch

import torch_gluon_cases as gc
from test_torch_gluon import CONV_LAYERS, LAYERS

torch.set_num_threads(2)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", CONV_LAYERS)
def test_layer_matches_mxtpu(name, hybrid):
    make, xs, *diff = LAYERS[name]
    gc.check(make, xs, diff[0] if diff else (0,), hybrid)
