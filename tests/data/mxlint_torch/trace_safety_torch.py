"""Seeded mxlint fixture (port idioms): MXL001 — torch calls inside a
hybrid_forward body break the port's Symbol trace as ``nd.concat``
broke the reference's. The F parameter shadows a module imported under
the same name. Never imported; AST only."""
import torch
import torch.nn.functional as F
import torch.nn.functional as TF
from mxtpu_torch.gluon.block import HybridBlock


def torch_at_module_level_is_fine(x):
    return torch.relu(x)  # not inside hybrid_forward: no finding


class Bad(HybridBlock):
    def hybrid_forward(self, F, x, y):
        a = torch.cat([x, y], dim=-1)  # seeded: MXL001
        b = TF.relu(x)  # seeded: MXL001
        c = torch.nn.functional.gelu(y)  # seeded: MXL001
        d = F.relu(x)  # the F parameter: no finding
        return a + b + c + d


class StillBadInNestedHelper(HybridBlock):
    def hybrid_forward(self, F, x):
        def helper(v):
            return torch.sigmoid(v)  # seeded: MXL001
        return helper(x)
