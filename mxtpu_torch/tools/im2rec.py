"""im2rec: build RecordIO image datasets — the port of ``tools/im2rec.py``
(reference ``tools/im2rec.py`` / ``tools/im2rec.cc``), through the port's
``recordio`` and ``mx.image``::

    python -m mxtpu_torch.tools.im2rec --list --recursive PREFIX ROOT
    python -m mxtpu_torch.tools.im2rec PREFIX ROOT

Two modes, like the reference:
  --list : walk an image directory, write a .lst (index\\tlabel\\tpath)
  (default): read a .lst + image root, encode to .rec (+.idx)
"""
from __future__ import annotations

import argparse
import os
import random

EXTS = (".jpg", ".jpeg", ".png")


def list_images(root: str, recursive: bool, exts=EXTS):
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in sorted(os.walk(root, followlinks=True)):
            dirs.sort()
            files.sort()
            for fname in files:
                fpath = os.path.join(path, fname)
                suffix = os.path.splitext(fname)[1].lower()
                if os.path.isfile(fpath) and suffix in exts:
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
    else:
        for fname in sorted(os.listdir(root)):
            fpath = os.path.join(root, fname)
            suffix = os.path.splitext(fname)[1].lower()
            if os.path.isfile(fpath) and suffix in exts:
                yield (i, os.path.relpath(fpath, root), 0)
                i += 1


def write_list(path_out: str, image_list) -> None:
    with open(path_out, "w") as fout:
        for i, (idx, relpath, label) in enumerate(image_list):
            fout.write(f"{idx}\t{label}\t{relpath}\n")


def read_list(path_in: str):
    with open(path_in) as fin:
        for line in fin:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield (int(parts[0]),
                   [float(x) for x in parts[1:-1]], parts[-1])


def make_rec(args) -> None:
    from .. import recordio
    from ..image import imdecode, imencode, resize_short
    prefix = os.path.splitext(args.prefix)[0]
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    count = 0
    for idx, label, relpath in read_list(args.lst):
        fpath = os.path.join(args.root, relpath)
        with open(fpath, "rb") as f:
            buf = f.read()
        if args.resize or args.quality != 95 or args.center_crop:
            img = imdecode(buf, as_numpy=True)
            if args.resize:
                img = resize_short(img, args.resize).asnumpy()
            if args.center_crop:
                h, w = img.shape[:2]
                s = min(h, w)
                y0, x0 = (h - s) // 2, (w - s) // 2
                img = img[y0:y0 + s, x0:x0 + s]
            buf = imencode(img, quality=args.quality)
        header = recordio.IRHeader(
            0, label[0] if len(label) == 1 else label, idx, 0)
        rec.write_idx(idx, recordio.pack(header, buf))
        count += 1
        if count % 1000 == 0:
            print(f"  packed {count} images")
    rec.close()
    print(f"wrote {count} records to {prefix}.rec")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("prefix", help="output prefix (.lst/.rec/.idx)")
    p.add_argument("root", help="image root directory")
    p.add_argument("--list", action="store_true",
                   help="create a .lst instead of a .rec")
    p.add_argument("--lst", help=".lst file to pack (default prefix.lst)")
    p.add_argument("--recursive", action="store_true",
                   help="label by subdirectory")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--resize", type=int, default=0,
                   help="resize shorter edge")
    p.add_argument("--center-crop", action="store_true")
    p.add_argument("--quality", type=int, default=95)
    args = p.parse_args()

    if args.list:
        images = list(list_images(args.root, args.recursive))
        if args.shuffle:
            random.shuffle(images)
            images = [(i, rel, lab) for i, (_, rel, lab)
                      in enumerate(images)]
        write_list(os.path.splitext(args.prefix)[0] + ".lst", images)
        print(f"wrote {len(images)} entries")
    else:
        args.lst = args.lst or os.path.splitext(args.prefix)[0] + ".lst"
        make_rec(args)


if __name__ == "__main__":
    main()
