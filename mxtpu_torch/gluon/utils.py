"""Gluon utilities — the port of ``mxtpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``)."""
from __future__ import annotations

import hashlib
import math
import os
import warnings
from typing import List, Optional

import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """Split a batch along ``batch_axis`` into ``num_slice`` chunks."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"batch size {size} not divisible by {num_slice} slices; "
            "set even_split=False")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Split a batch across devices (reference API): one slice per
    device of ``ctx_list``, each moved there."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Rescale arrays so their joint L2 norm ≤ max_norm
    (reference ``gluon.utils.clip_global_norm``); returns the norm."""
    total = None
    for a in arrays:
        sq = torch.sum(torch.square(a._data.to(torch.float32)))
        total = sq if total is None else total + sq
    norm_f = float(torch.sqrt(total))
    if check_isfinite and not math.isfinite(norm_f):
        warnings.warn("nan or inf in clip_global_norm")
    scale = max_norm / (norm_f + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._set_data(a._data * scale)
    return norm_f


def check_sha1(filename: str, sha1_hash: str) -> bool:
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path: Optional[str] = None, overwrite: bool = False,
             sha1_hash: Optional[str] = None, retries: int = 5,
             verify_ssl: bool = True) -> str:
    """Download helper (reference API) that never touches the network:
    it returns the file when it is already on disk, and raises
    otherwise."""
    fname = path if path and not os.path.isdir(path) else os.path.join(
        path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        f"cannot download {url}: this package fetches nothing; place the "
        f"file at {fname}")
