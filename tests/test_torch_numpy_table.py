"""The second half of ``mx.np``'s function table against the
reference's on the CPU (``torch_np_cases``; the first half and the
enumeration of ``jax.numpy``'s names are ``test_torch_numpy.py``'s)."""
import pytest
import torch

import torch_np_cases as nc

torch.set_num_threads(2)


@pytest.mark.parametrize("name", nc.SECOND_HALF)
def test_np_function_matches_reference(name, tmp_path):
    nc.check_case(name, tmp_path)
