"""Write the JPEG fixtures under ``tests/data/jpeg/``: a few small
photographic-like images (gradients, a tint, seeded noise), each as
``<name>.src.npy`` (the pixels), ``<name>.jpg`` (encoded at quality 95
by the native library) and its decodes ``<name>.rgb.npy`` and
``<name>.luma.npy``.

Run it where the native library builds with libjpeg: the ``.npy``
decodes are libjpeg's, which ``chip_smoke.py``'s ``image_record``
phase holds a host's other codec (nvJPEG) against, and
``tests/test_torch_native.py`` checks they are still libjpeg's::

    python -m mxtpu_torch.tools.jpeg_fixtures [--out tests/data/jpeg]
"""
from __future__ import annotations

import argparse
import os

import numpy as onp

SHAPES = {"gradient": (72, 96), "odd": (61, 83), "square": (64, 64)}


def photo(rng, h, w, tint):
    y, x = onp.mgrid[0:h, 0:w].astype(onp.float32)
    base = onp.stack([x / w * 200, y / h * 200, (x + y) / (h + w) * 200],
                     axis=-1) + onp.asarray(tint, onp.float32)
    return onp.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        onp.uint8)


def write(out: str) -> None:
    from .. import native
    if native.backend() != "libjpeg":
        raise SystemExit(f"the fixtures are libjpeg's decodes; this "
                         f"library is built with {native.backend()}")
    os.makedirs(out, exist_ok=True)
    rng = onp.random.default_rng(0)
    for i, (name, (h, w)) in enumerate(sorted(SHAPES.items())):
        img = photo(rng, h, w, [20 * i, 30, 50 - 10 * i])
        buf = native.jpeg_encode(img, quality=95)
        onp.save(os.path.join(out, f"{name}.src.npy"), img)
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(buf)
        onp.save(os.path.join(out, f"{name}.rgb.npy"),
                 native.jpeg_decode(buf, 3))
        onp.save(os.path.join(out, f"{name}.luma.npy"),
                 native.jpeg_decode(buf, 1))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    write(p.parse_args().out)


if __name__ == "__main__":
    main()
