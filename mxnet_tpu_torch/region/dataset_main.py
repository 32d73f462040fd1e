#!/usr/bin/env python
"""Build the region drill's dataset: ``n`` seeded 16x16 JPEG records with
label ``i % 7`` in a ``.rec``/``.idx`` pair (the counterpart of the
dataset script the JAX package's ``tools/region.py`` generates,
``:101-127``; the same images from ``RandomState(0)``).

::

    python mxnet_tpu_torch/region/dataset_main.py region.rec region.idx 48

Torch-free: ``recordio`` loads through the stub package and encodes with
cv2 (PIL where cv2 is missing).
"""
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)


def build(recordio, np, rec, idx, n):
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(0)
    for i in range(n):
        img = rs.randint(0, 255, (16, 16, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 7), i, 0), img, quality=95,
            img_fmt=".jpg"))
    w.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        raise SystemExit("usage: dataset_main.py REC IDX N")
    sys.path.insert(0, _HERE)
    import region_main      # installs the stub package (and pops _HERE)
    region_main.bootstrap()
    import numpy as np
    from mxnet_tpu_torch import recordio
    rec, idx, n = argv[0], argv[1], int(argv[2])
    build(recordio, np, rec, idx, n)
    print("REGION_DATASET records=%d" % n, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
