"""mx.image — the port of ``mxtpu/image`` (reference
``python/mxnet/image/``): decode / resize / augment / iterate over
images, and the detection pipeline (``ImageDetIter`` with the Det*
augmenters). JPEG goes through the native library's codec, PNG through
stdlib ``zlib`` and numpy (``image.py`` says how each differs from the
reference's TensorFlow codec).
"""
from .image import *         # noqa: F401,F403
from .image import (imdecode, imencode, imread, imresize, resize_short,
                    fixed_crop, random_crop, center_crop, color_normalize,
                    CreateAugmenter, Augmenter, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, HorizontalFlipAug,
                    CastAug, ColorNormalizeAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, ColorJitterAug,
                    LightingAug, RandomSizedCropAug, ImageIter)
from .detection import (DetAugmenter, DetBorrowAug,         # noqa: F401
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter,
                        ImageDetIter)
