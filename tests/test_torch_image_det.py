"""The port's detection pipeline (``mxnet_tpu_torch/image_det.py``) against
the JAX package's on the CPU: ``ImageDetRecordIter`` batches and padded
labels over a seeded detection ``.rec`` (sequential, indexed, shuffled,
partitioned), ``CreateDetAugmenter`` and every ``Det*Aug`` under fixed
seeds.  Tolerance: exact (the same decoder, the same ``random`` draws, the
same cv2 resize)."""
import os
import random
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import image_det as jdet  # noqa: E402
from mxnet_tpu_torch import image_det as tdet  # noqa: E402

SHAPE = (3, 32, 40)


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("det")
    prefix = str(d / "det")
    chip_smoke.write_seeded_rec(tmx.recordio, prefix, 13, 40, seed=4,
                                det=True)
    return prefix


def _batches(mod, prefix, seed=0, **kw):
    random.seed(seed)
    np.random.seed(seed)
    with mod.cpu():
        it = mod.io.ImageDetRecordIter(prefix + ".rec", SHAPE, 4, **kw)
        out = []
        for _ in range(2):
            out += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
            it.reset()
        return out, it.provide_label


@pytest.mark.parametrize("case", ["plain", "indexed_shuffle", "augmented",
                                  "partition"])
def test_det_record_iter_equal(det_rec, case):
    kw = {
        "plain": dict(mean_r=123.0, mean_g=117.0, mean_b=104.0),
        "indexed_shuffle": dict(path_imgidx=det_rec + ".idx", shuffle=True,
                                label_pad_width=20, label_pad_value=-2.0),
        "augmented": dict(rand_crop_prob=0.7, rand_pad_prob=0.5,
                          rand_mirror_prob=0.5, max_pad_scale=1.5,
                          std_r=2.0, std_g=2.0, std_b=2.0),
        "partition": dict(num_parts=2, part_index=1),
    }[case]
    (j, jl), (t, tl) = _batches(jmx, det_rec, **kw), \
        _batches(tmx, det_rec, **kw)
    assert [tuple(d) for d in jl] == [tuple(d) for d in tl]
    assert len(j) == len(t) > 0
    for (dj, lj, pj), (dt, lt, pt) in zip(j, t):
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
        assert pj == pt
    width = tl[0].shape[1] - 4
    lab = t[0][1]
    assert lab.shape == (4, width + 4)
    assert (lab[:, 0] == 3).all() and (lab[:, 1] == SHAPE[1]).all()
    assert (lab[:, 2] == SHAPE[2]).all()


@pytest.mark.parametrize("name", ["DetHorizontalFlipAug", "DetRandomCropAug",
                                  "DetRandomPadAug", "DetForceResizeAug",
                                  "CreateDetAugmenter"])
def test_det_augmenters_equal(name):
    rs = np.random.RandomState(2)
    src = (rs.rand(45, 53, 3) * 255).astype(np.uint8)
    flat = chip_smoke.detection_label(np.random.RandomState(6))
    outs = []
    for mod in (jdet, tdet):
        augs = {
            "DetHorizontalFlipAug": [mod.DetHorizontalFlipAug(0.5)],
            "DetRandomCropAug": [mod.DetRandomCropAug(prob=1.0,
                                                      min_overlap=0.05)],
            "DetRandomPadAug": [mod.DetRandomPadAug(prob=1.0)],
            "DetForceResizeAug": [mod.DetForceResizeAug((30, 20))],
            "CreateDetAugmenter": mod.CreateDetAugmenter(
                SHAPE, rand_crop_prob=0.5, rand_pad_prob=0.5,
                rand_mirror_prob=0.5, mean=[1.0, 2.0, 3.0])}[name]
        res = []
        for seed in range(4):
            random.seed(seed)
            img, label = src, mod._DetLabel(flat)
            for a in augs:
                img, label = a(img, label)
            res.append((np.asarray(img), label.flat()))
        outs.append(res)
    for (ij, lj), (it_, lt) in zip(*outs):
        np.testing.assert_array_equal(ij, it_)
        np.testing.assert_array_equal(lj, lt)


def test_det_label_errors(det_rec, tmp_path):
    with pytest.raises(tmx.MXNetError):
        tdet._DetLabel([2.0, 3.0, 1.0])
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="label_pad_width"):
        tmx.io.ImageDetRecordIter(det_rec + ".rec", SHAPE, 4,
                                  label_pad_width=3)
