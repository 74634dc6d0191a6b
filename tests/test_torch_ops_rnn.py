"""Parity of the port's recurrent ops (``ctc_loss``'s log-alpha
recursion and the fused ``RNN``: LSTM, GRU and vanilla, stacked and
bidirectional, with and without state outputs) with
``mxtpu.ndarray.ops`` on the CPU: the cases of ``torch_op_cases.py``,
values and gradients compared at its tolerances."""
import pytest
import torch

import torch_op_cases as oc
from test_torch_ops import check_case

torch.set_num_threads(2)


@pytest.mark.parametrize("op,k", [(op, k) for op in oc.SEQ
                                  for k in range(len(oc.CASES[op]))])
def test_op_matches_mxtpu(op, k):
    check_case(op, oc.CASES[op][k])
