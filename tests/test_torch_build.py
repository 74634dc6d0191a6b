"""The port's kernel build: every CUDA source and header under
``mxtpu_torch/ops/csrc`` is compiled or hashed, so editing any of them
builds the library anew (``build/mxtpu_torch_kernels/<hash>/``).

These run on the CPU: nothing here calls ``nvcc``.
"""
import re
import shutil

import pytest
import torch

from mxtpu_torch.ops import _build

torch.set_num_threads(2)   # a CPU share for each xdist worker

CSRC = _build._CSRC


def test_every_csrc_file_is_a_source_or_a_header():
    on_disk = {p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert on_disk == listed, (
        f"not in _build.SOURCES or HEADERS: {sorted(on_disk - listed)}; "
        f"listed but missing: {sorted(listed - on_disk)}")
    assert all(n.endswith(".cu") for n in _build.SOURCES)
    assert all(n.endswith(".cuh") for n in _build.HEADERS)


def test_every_included_local_header_is_hashed():
    """A source's ``#include "x.cuh"`` names a header in HEADERS; a
    system include (<...>) is the toolkit's."""
    for name in _build.SOURCES + _build.HEADERS:
        text = (CSRC / name).read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc in _build.HEADERS, f"{name} includes {inc}"


def test_the_forward_kernel_uses_the_hopper_header():
    text = (CSRC / "flash_attn_fwd.cu").read_text()
    assert '#include "hopper_common.cuh"' in text
    assert "hopper::wgmma_" in text and "hopper::tma_load_4d" in text
    # the mma.sync forward is gone: no mma.sync helpers
    assert '#include "flash_common.cuh"' not in text


def test_the_backward_kernels_use_the_hopper_header():
    text = (CSRC / "flash_attn_bwd.cu").read_text()
    assert '#include "hopper_common.cuh"' in text
    assert "hopper::wgmma_" in text and "hopper::tma_load_4d" in text
    # the mma.sync backward is gone: no mma.sync helpers
    assert '#include "flash_common.cuh"' not in text


def test_the_conv_kernel_uses_the_hopper_header():
    text = (CSRC / "conv3x3.cu").read_text()
    assert '#include "hopper_common.cuh"' in text
    assert "hopper::wgmma_" in text
    assert "hopper::tma_load_4d_im2col" in text and "hopper::tma_load_4d(" in text
    # the mma.sync conv is gone, and with it the last user of the
    # mma.sync helpers' header
    assert '#include "flash_common.cuh"' not in text
    assert "mma.sync.aligned" not in text and "mma_16816" not in text
    assert not (CSRC / "flash_common.cuh").exists()


@pytest.mark.parametrize("name", _build.SOURCES + _build.HEADERS)
def test_editing_any_file_changes_the_build_hash(name, tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    before = _build._digest()
    assert _build._digest() == before            # a pure function of the files
    with open(copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build._digest() != before
