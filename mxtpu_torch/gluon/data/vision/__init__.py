"""Vision datasets and transforms — the port of
``mxtpu/gluon/data/vision`` (reference ``gluon.data.vision``)."""
from .datasets import (CIFAR10, CIFAR100, FashionMNIST, ImageFolderDataset,
                       MNIST)
from . import transforms
