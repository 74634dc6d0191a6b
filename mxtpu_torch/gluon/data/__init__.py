"""Data loading — the port of ``mxtpu/gluon/data`` (reference
``python/mxnet/gluon/data/``): datasets, samplers, the DataLoader (its
worker processes are numpy-only and never see the card), and
``DevicePrefetcher``, which uploads the next batch to the card while
the current step runs. Batches come out of a DataLoader on the host,
as MXNet's do."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader, default_batchify_fn
from .prefetcher import DevicePrefetcher
from . import vision
