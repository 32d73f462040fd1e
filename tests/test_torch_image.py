"""The port's image pipeline (``mxnet_tpu_torch/image.py``) against the JAX
package's, on the CPU at 20-64 px: ``ImageRecordIter`` on its three routes
(native libjpeg pipe, decode worker processes, the host engine),
``ImageIter``, every augmenter and image function, and the arithmetic of
the nvJPEG decode backend (``crop_plan``/``pack_image``) against the
libjpeg pipe.

Tolerance: byte-equal everywhere (both packages run the same C++ decoder,
the same augmenters and the same ``random``/``np.random`` draws from the
same seeds); bfloat16 batches compare as bits.

``python tests/test_torch_image.py`` rewrites ``tests/data/
nvjpeg_fixture.npz``: JPEGs, the JAX package's libjpeg decode of them and
its native pipe's batch, which ``chip_smoke.py`` holds the nvJPEG backend
against on a card whose host has no libjpeg."""
import os
import random
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import image as jimg  # noqa: E402
from mxnet_tpu_torch import image as timg  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "nvjpeg_fixture.npz")
SHAPE = (3, 24, 28)
MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53)
STD = dict(std_r=58.395, std_g=57.12, std_b=57.375)


def _write_rec(mod, prefix, n=20, seed=0, bad_at=None, sizes=(20, 64)):
    rs = np.random.RandomState(seed)
    rec = mod.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i in range(n):
        h, w = rs.randint(*sizes), rs.randint(*sizes)
        img = chip_smoke.seeded_image(rs, h, w)
        label = float(rs.randint(0, 10))
        if i == bad_at:
            s = mod.recordio.pack((0, label, i, 0), b"\xff\xd8 not a jpeg")
        else:
            s = mod.recordio.pack_img((0, label, i, 0), img, quality=90)
        rec.write_idx(i, s)
    rec.close()


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    _write_rec(tmx, str(d / "a"))
    _write_rec(tmx, str(d / "bad"), bad_at=5)
    return str(d)


def _bits(arr):
    """A batch as comparable numpy: bfloat16 as its bits."""
    if isinstance(arr, tmx.nd.NDArray):
        t = arr._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().view(np.uint16)
        return arr.numpy()
    if isinstance(arr, np.ndarray):
        a = arr
    else:
        a = arr.asnumpy()
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _epochs(mod, path, epochs=2, reset_after=None, **kw):
    """Batches of ``epochs`` epochs of ``mod``'s ImageRecordIter on the
    CPU: [(data bits, label, pad), ...] per epoch, and the route."""
    with mod.cpu():
        it = mod.io.ImageRecordIter(path + ".rec", SHAPE, 8, seed=7, **kw)
        out = []
        for e in range(epochs):
            batches = []
            for j, b in enumerate(it):
                batches.append((_bits(b.data[0]), _bits(b.label[0]),
                                b.pad))
                if reset_after is not None and e == 0 and \
                        j + 1 == reset_after:
                    break
            out.append(batches)
            it.reset()
        route = getattr(it, "route", type(getattr(it, "_pipeline", None)
                                          ).__name__)
        it.close()
    return out, route


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert da.dtype == db.dtype and da.shape == db.shape
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(la, lb)
            assert pa == pb


@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "bfloat16"])
def test_native_route_batches_equal(rec, monkeypatch, fast, layout, dtype):
    """Two epochs (a fresh augmentation each) of the native route, with the
    fast and the exact IDCT, both layouts and every native dtype."""
    monkeypatch.setenv("MXNET_JPEG_DECODE_FAST", fast)
    kw = dict(rand_crop=True, rand_mirror=True, dtype=dtype, layout=layout,
              preprocess_threads=2)
    if dtype != "uint8":
        kw.update(MEAN, **STD)
    j, jr = _epochs(jmx, rec + "/a", **kw)
    t, tr = _epochs(tmx, rec + "/a", **kw)
    assert jr == "_NativePipeline" and tr == "native"
    _assert_same(j, t)
    assert [p for _, _, p in t[0]] == [0, 0, 4]         # the tail batch
    assert not np.array_equal(t[0][0][0], t[1][0][0])   # fresh each epoch


def test_native_route_bad_record_partition_reset(rec):
    kw = dict(rand_crop=True, rand_mirror=True, preprocess_threads=1)
    # a bad record is skipped: the first batch holds 7 images
    j, _ = _epochs(jmx, rec + "/bad", epochs=1, **kw)
    t, _ = _epochs(tmx, rec + "/bad", epochs=1, **kw)
    _assert_same(j, t)
    assert [p for _, _, p in t[0]] == [1, 0, 4]
    # a partition of the indexed file
    part = dict(kw, path_imgidx=rec + "/a.idx", part_index=1, num_parts=2,
                shuffle=True)
    j, _ = _epochs(jmx, rec + "/a", **part)
    t, _ = _epochs(tmx, rec + "/a", **part)
    _assert_same(j, t)
    assert [p for _, _, p in t[0]] == [0, 6]
    # a reset after one batch of the first epoch
    j, _ = _epochs(jmx, rec + "/a", reset_after=1, **kw)
    t, _ = _epochs(tmx, rec + "/a", reset_after=1, **kw)
    _assert_same(j, t)
    assert len(t[0]) == 1 and len(t[1]) == 3


def test_native_route_resize_and_host_batches(rec):
    kw = dict(resize=40, rand_crop=False, preprocess_threads=2, **MEAN)
    j, _ = _epochs(jmx, rec + "/a", epochs=1, **kw)
    t, _ = _epochs(tmx, rec + "/a", epochs=1, **kw)
    _assert_same(j, t)
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8, seed=3,
                                        host_batches=True, dtype="bfloat16",
                                        rand_mirror=True)
            outs.append([(_bits(b.data[0]), np.asarray(b.label[0]))
                         for b in it])
            it.close()
    for (dj, lj), (dt, lt) in zip(*outs):
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8,
                                    host_batches=True)
        b = it.next()
        assert isinstance(b.data[0], torch.Tensor) and \
            not b.data[0].is_pinned()
        it.close()


def test_process_route_equal(rec):
    """The example's train arguments (``pad=0`` keeps them off the native
    route): two decode worker processes in each package."""
    kw = dict(rand_crop=True, rand_mirror=True, pad=0, max_random_scale=1.0,
              min_random_scale=1.0, preprocess_threads=2, **MEAN)
    j, jr = _epochs(jmx, rec + "/a", **kw)
    t, tr = _epochs(tmx, rec + "/a", **kw)
    assert jr == "_ProcessPipeline" and tr == "process"
    _assert_same(j, t)
    # the native route gives other pixels (another resampler and seeds)
    n, _ = _epochs(tmx, rec + "/a", epochs=1, rand_crop=True,
                   rand_mirror=True, preprocess_threads=2, **MEAN)
    assert n[0][0][0].shape == t[0][0][0].shape


def test_engine_route_equal(rec, monkeypatch):
    """A custom aug_list takes the engine route; so does
    MXNET_RECORDITER_PROCS=0 for the built-in augmenters."""
    outs = []
    for mod in (jmx, tmx):
        augs = [mod.image.RandomCropAug((SHAPE[2], SHAPE[1])),
                mod.image.HorizontalFlipAug(0.5), mod.image.CastAug()]
        outs.append(_epochs(mod, rec + "/a", aug_list=augs, dtype="uint8",
                            preprocess_threads=2))
    assert outs[1][1] == "engine"
    _assert_same(outs[0][0], outs[1][0])
    monkeypatch.setenv("MXNET_RECORDITER_PROCS", "0")
    monkeypatch.setenv("MXNET_RECORDITER_NATIVE", "0")
    kw = dict(rand_crop=True, rand_mirror=True, preprocess_threads=2,
              dtype="bfloat16", **MEAN)
    j, _ = _epochs(jmx, rec + "/a", **kw)
    t, tr = _epochs(tmx, rec + "/a", **kw)
    assert tr == "engine"
    _assert_same(j, t)


def test_uint8_iter_and_provide(rec):
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.ImageRecordUInt8Iter(rec + "/a.rec", SHAPE, 8,
                                             seed=1, rand_crop=True)
            outs.append(([_bits(b.data[0]) for b in it], it.provide_data,
                         it.provide_label))
            it.close()
            with pytest.raises(mod.MXNetError):
                mod.io.ImageRecordUInt8Iter(rec + "/a.rec", SHAPE, 8,
                                            mean_r=1.0)
    for a, b in zip(outs[0][0], outs[1][0]):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert [tuple(d) for d in outs[0][1]] == [tuple(d) for d in outs[1][1]]
    assert [tuple(d) for d in outs[0][2]] == [tuple(d) for d in outs[1][2]]


def test_service_options_raise_naming_the_next_slice(rec, monkeypatch):
    """The service options (ported since this test was written): explicit
    requests that the service cannot express raise with the JAX package's
    messages, the variable routes an eligible iterator and falls back for
    an ineligible one, and data_service=False keeps the in-process
    route."""
    monkeypatch.setenv("MXTPU_DATA_NET_RETRIES", "1")
    with tmx.cpu():
        for kw, msg in ((dict(data_service=True), "path_imgidx"),
                        (dict(data_service="h:1"), "path_imgidx"),
                        (dict(device_augment=True), "device_augment"),
                        (dict(device_augment=0), "device_augment")):
            with pytest.raises(tmx.MXNetError, match=msg):
                tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8, **kw)
        monkeypatch.setenv("MXTPU_DATA_WORKERS", "2")
        it = tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8)
        assert it.route == "native" and it.stats() is None   # no .idx
        it.close()
        it = tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8,
                                    path_imgidx=rec + "/a.idx")
        assert it.route == "service" and it.stats()["num_workers"] == 2
        it.close()
        it = tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8,
                                    path_imgidx=rec + "/a.idx",
                                    data_service=False)
        assert it.route == "native" and it.stats() is None
        it.close()


def test_image_iter_rec_and_list(rec, tmp_path):
    import cv2
    outs = []
    for mod in (jmx, tmx):
        it = mod.image.ImageIter(4, SHAPE, path_imgrec=rec + "/a.rec",
                                 path_imgidx=rec + "/a.idx", shuffle=True,
                                 seed=2, rand_crop=True, rand_mirror=True,
                                 **{"mean": True, "std": True})
        random.seed(4)
        np.random.seed(4)
        outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                     for b in it])
    _assert_same([outs[0]], [outs[1]])
    rs = np.random.RandomState(1)
    files = []
    for i in range(5):
        name = "%d.png" % i
        cv2.imwrite(str(tmp_path / name),
                    (rs.rand(30, 34, 3) * 255).astype(np.uint8))
        files.append(([float(i), 2.0 * i], name))
    lst = tmp_path / "files.lst"
    lst.write_text("".join("%d\t%f\t%f\t%s\n" % (i, lab[0], lab[1], name)
                           for i, (lab, name) in enumerate(files)))
    for kw in (dict(imglist=files), dict(path_imglist=str(lst))):
        outs = []
        for mod in (jmx, tmx):
            it = mod.image.ImageIter(2, SHAPE, label_width=2,
                                     path_root=str(tmp_path), **kw)
            outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                          b.pad) for b in it])
            assert it.provide_label[0].shape == (2, 2)
        _assert_same([outs[0]], [outs[1]])
        assert outs[1][-1][2] == 1


def _augmenters(mod):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    im = mod.image
    return {
        "ResizeAug": im.ResizeAug(30),
        "RandomCropAug": im.RandomCropAug((20, 18)),
        "RandomSizedCropAug": im.RandomSizedCropAug((20, 18), 0.3,
                                                    (0.75, 1.333)),
        "CenterCropAug": im.CenterCropAug((20, 18)),
        "RandomOrderAug": im.RandomOrderAug([im.CastAug(),
                                             im.HorizontalFlipAug(1.0)]),
        "ColorJitterAug": im.ColorJitterAug(0.4, 0.4, 0.4),
        "LightingAug": im.LightingAug(0.1, eigval, eigvec),
        "ColorNormalizeAug": im.ColorNormalizeAug([1.0, 2.0, 3.0],
                                                  [2.0, 2.0, 4.0]),
        "HorizontalFlipAug": im.HorizontalFlipAug(0.5),
        "CastAug": im.CastAug(),
        "PadAug": im.PadAug(4, 255),
        "CreateAugmenter": im.CreateAugmenter(
            (3, 20, 18), resize=30, rand_crop=True, rand_resize=True,
            rand_mirror=True, mean=True, std=True, brightness=0.2,
            contrast=0.2, saturation=0.2, pca_noise=0.1, pad=2),
    }


AUGMENTERS = ("CastAug", "CenterCropAug", "ColorJitterAug",
              "ColorNormalizeAug", "CreateAugmenter", "HorizontalFlipAug",
              "LightingAug", "PadAug", "RandomCropAug", "RandomOrderAug",
              "RandomSizedCropAug", "ResizeAug")


@pytest.mark.parametrize("name", AUGMENTERS)
def test_augmenter_equal(name):
    rs = np.random.RandomState(9)
    src = (rs.rand(33, 41, 3) * 255).astype(np.uint8)
    outs = []
    for mod in (jmx, tmx):
        aug = _augmenters(mod)[name]
        augs = aug if isinstance(aug, list) else [aug]
        out = []
        for seed in (0, 1, 2):
            random.seed(seed)
            np.random.seed(seed)
            img = src
            for a in augs:
                img = a(img)[0]
            out.append(np.asarray(img))
        outs.append(out)
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_image_functions_equal():
    import cv2
    rs = np.random.RandomState(3)
    src = (rs.rand(37, 29, 3) * 255).astype(np.uint8)
    ok, jpg = cv2.imencode(".jpg", src)
    ok2, png = cv2.imencode(".png", src)
    assert ok and ok2
    for buf in (jpg.tobytes(), png.tobytes()):
        for flag, rgb in ((1, 1), (1, 0), (0, 1)):
            np.testing.assert_array_equal(
                timg.imdecode(buf, flag, rgb), jimg.imdecode(buf, flag, rgb))
    assert timg.scale_down((30, 20), (40, 25)) == \
        jimg.scale_down((30, 20), (40, 25))
    for fn, args in (("resize_short", (20,)), ("imresize", (13, 17)),
                     ("fixed_crop", (2, 3, 10, 12, (8, 9))),
                     ("color_normalize", ([1., 2., 3.], [2., 3., 4.]))):
        np.testing.assert_array_equal(getattr(timg, fn)(src, *args),
                                      getattr(jimg, fn)(src, *args))
    for fn, args in (("random_crop", ((20, 30),)),
                     ("center_crop", ((20, 14),)),
                     ("random_size_crop", ((16, 16), 0.3, (0.75, 1.33)))):
        outs = []
        for mod in (jimg, timg):
            random.seed(8)
            outs.append(getattr(mod, fn)(src, *args))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert tuple(outs[0][1]) == tuple(outs[1][1])


def test_nvjpeg_backend_arithmetic_matches_libjpeg_pipe(rec, monkeypatch):
    """``crop_plan`` + ``pack_image`` on the exact libjpeg decode give the
    native pipe's bytes (exact IDCT), 1:1 crops and bilinear resamples
    alike: what the nvJPEG backend computes on a card from its decode."""
    monkeypatch.setenv("MXNET_JPEG_DECODE_FAST", "0")
    raws = []
    r = tmx.recordio.MXIndexedRecordIO(rec + "/a.idx", rec + "/a.rec", "r")
    for k in r.keys:
        raws.append(tmx.recordio.unpack(r.read_idx(k))[1])
    r.close()
    for dtype, layout, norm in (("uint8", "NCHW", False),
                                ("float32", "NHWC", True),
                                ("bfloat16", "NCHW", True)):
        kw = dict(MEAN, **STD) if norm else {}
        with tmx.cpu():
            it = tmx.io.ImageRecordIter(rec + "/a.rec", SHAPE, 8, seed=5,
                                        dtype=dtype, layout=layout,
                                        rand_crop=True, rand_mirror=True,
                                        preprocess_threads=1, **kw)
            assert it._pipeline.backend == "libjpeg"
            got = [b.data[0]._data.clone() for b in it]
            it.close()
        tdt = timg._TORCH_DTYPES[dtype]
        nrm = None
        if norm:
            m = np.array([MEAN["mean_r"], MEAN["mean_g"], MEAN["mean_b"]],
                         np.float32)
            sd = np.array([STD["std_r"], STD["std_g"], STD["std_b"]],
                          np.float32)
            nrm = (torch.tensor(m), torch.tensor(np.float32(1) / sd))
        for b, ref in enumerate(got):
            out = torch.zeros_like(ref)
            cseed = timg._chunk_seed(5, b, epoch=1)
            for i, raw in enumerate(raws[b * 8:(b + 1) * 8]):
                img = torch.from_numpy(timg.imdecode(raw))
                plan = timg.crop_plan(img.shape[0], img.shape[1], SHAPE[1],
                                      SHAPE[2], True, True,
                                      timg._mix_seed(cseed, i))
                timg.pack_image(img, out[i], plan, nrm, tdt, layout)
            np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("h,w", [(72, 96), (31, 45), (17, 5), (3, 4),
                                 (64, 64)])
def test_nvjpeg_backend_upsampling_and_color_match_libjpeg(h, w):
    """``upsample_chroma`` + ``ycc_to_rgb`` on the coded planes give
    libjpeg's RGB decode exactly (4:2:0 and 4:4:4).  The coded chroma
    planes come from libjpeg itself (PIL's half-scale YCbCr decode keeps
    chroma at its coded size with the full 8x8 IDCT); the luma from its
    full-scale YCbCr decode."""
    import io
    import cv2
    from PIL import Image
    img = chip_smoke.seeded_image(np.random.RandomState(h * w), h, w)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    sub = 2
    if h == w:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
        sub = 0
    jpg = cv2.imencode(".jpg", img, params)[1].tobytes()
    full = Image.open(io.BytesIO(jpg))
    full.draft("YCbCr", full.size)
    ycc = np.asarray(full)
    coded = ycc
    if sub == 2:
        half = Image.open(io.BytesIO(jpg))
        half.draft("YCbCr", (max(1, w // 2), max(1, h // 2)))
        coded = np.asarray(half)
        assert coded.shape[:2] == ((h + 1) // 2, (w + 1) // 2)
    planes = [timg.upsample_chroma(torch.from_numpy(
        np.ascontiguousarray(coded[..., c])), sub, h, w) for c in (1, 2)]
    rgb = timg.ycc_to_rgb(torch.from_numpy(ycc[..., 0].astype(np.int32)),
                          *planes)
    np.testing.assert_array_equal(rgb.numpy(), timg.imdecode(jpg))


def test_fancy_upsampling_matches_libjpeg_loops():
    """The vectorized 4:2:2 and 4:2:0 upsamplers against a transcription
    of libjpeg's loops (jdsample.c: h2v1_fancy_upsample,
    h2v2_fancy_upsample)."""
    def h2v1(row):
        n, out = len(row), []
        for j in range(n):
            prev, nxt = row[max(j - 1, 0)], row[min(j + 1, n - 1)]
            out += [(3 * row[j] + prev + 1) >> 2, (3 * row[j] + nxt + 2) >> 2]
        out[0], out[-1] = row[0], row[-1]
        return out

    def h2v2(x):
        m, n = x.shape
        out = np.zeros((2 * m, 2 * n), np.int64)
        for i in range(m):
            for v, other in ((0, max(i - 1, 0)), (1, min(i + 1, m - 1))):
                c = 3 * x[i] + x[other]
                r = out[2 * i + v]
                r[0] = (c[0] * 4 + 8) >> 4
                r[1] = (c[0] * 3 + c[min(1, n - 1)] + 7) >> 4
                for j in range(1, n):
                    r[2 * j] = (3 * c[j] + c[j - 1] + 8) >> 4
                    r[2 * j + 1] = (3 * c[j] + c[min(j + 1, n - 1)] + 7) >> 4
                r[-1] = (c[-1] * 4 + 7) >> 4
        return out

    x = np.random.RandomState(0).randint(0, 256, (5, 7)).astype(np.int64)
    t = torch.from_numpy(x.astype(np.uint8))
    np.testing.assert_array_equal(
        timg.upsample_chroma(t, 1, 5, 14).numpy(),
        np.array([h2v1(list(r)) for r in x]))
    np.testing.assert_array_equal(timg.upsample_chroma(t, 2, 10, 14).numpy(),
                                  h2v2(x))
    np.testing.assert_array_equal(timg.upsample_chroma(t, 2, 9, 13).numpy(),
                                  h2v2(x)[:9, :13])


def test_nvjpeg_backend_batched_pack_equals_per_image():
    """``pack_planes_batch`` (the stacked 1:1 crops of one subsampling)
    writes what ``pack_image(planes_to_rgb(...))`` writes image by image,
    for every subsampling, dtype, layout and odd/even crop offsets."""
    rs = np.random.RandomState(0)
    for trial in range(24):
        sub = trial % 4
        oh, ow = ((24, 28), (23, 27))[trial % 2]
        layout = ("NCHW", "NHWC")[trial // 4 % 2]
        dtype = (torch.uint8, torch.float32, torch.bfloat16)[trial % 3]
        norm = None if trial % 5 == 0 else (
            torch.tensor([123.68, 116.28, 103.53]),
            torch.tensor(np.float32(1) / np.array([58.4, 57.1, 57.4],
                                                  np.float32)))
        shape = (5, 3, oh, ow) if layout == "NCHW" else (5, oh, ow, 3)
        out, ref = torch.zeros(shape, dtype=dtype), torch.zeros(shape,
                                                                dtype=dtype)
        items = []
        for k in range(5):
            h, w = rs.randint(oh, oh + 30), rs.randint(ow, ow + 30)
            cshape = {0: (h, w), 1: (h, (w + 1) // 2),
                      2: ((h + 1) // 2, (w + 1) // 2)}.get(sub)
            planes = [torch.from_numpy(rs.randint(0, 256, s_).astype(
                np.uint8)) for s_ in [(h, w)] + ([cshape] * 2 if cshape
                                                  else [])]
            plan = timg.crop_plan(h, w, oh, ow, True, True,
                                  int(rs.randint(1 << 30)))
            assert timg._batchable(sub, planes, plan, oh, ow)
            items.append((sub, planes, plan))
            timg.pack_image(timg.planes_to_rgb(sub, planes, h, w), ref[k],
                            plan, norm, dtype, layout)
        timg.pack_planes_batch(items, out, [4, 3, 2, 1, 0], norm, dtype,
                               layout)
        np.testing.assert_array_equal(_bits(out.flip(0)), _bits(ref))


def test_nvjpeg_backend_batch_equals_fixture_on_libjpeg_planes(
        monkeypatch):
    """The nvJPEG backend's batch path (``_decode_nvjpeg``) with libjpeg's
    coded planes in place of nvJPEG's gives the JAX package's libjpeg
    batch of the fixture byte for byte."""
    import contextlib
    import io
    from PIL import Image

    class LibjpegPlanes(object):
        def decode_planes(self, raw):
            full = Image.open(io.BytesIO(raw))
            w, h = full.size
            if full.mode == "L":
                return 3, [torch.from_numpy(np.asarray(full).copy())], h, w
            full.draft("YCbCr", full.size)
            ycc = np.asarray(full)
            coded, sub = ycc, 0
            if full.layer[1][1:3] == (1, 1) and full.layer[0][1:3] == (2, 2):
                half = Image.open(io.BytesIO(raw))
                half.draft("YCbCr", (max(1, w // 2), max(1, h // 2)))
                coded, sub = np.asarray(half), 2
            return sub, [torch.from_numpy(np.ascontiguousarray(
                a[..., c])) for c, a in ((0, ycc), (1, coded),
                                         (2, coded))], h, w

    class Event(object):
        def record(self, stream):
            pass

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    n = len([k for k in fx if k.startswith("jpeg_")])
    crop = [int(v) for v in fx["crop"]]
    p = timg._NativePipeline.__new__(timg._NativePipeline)
    p._bs, p._lw, p._shape = n, 1, (3, crop[0], crop[1])
    p._uploader = tmx.dataflow.Uploader("cpu")
    p._nvjpeg, p._crop, p._norm = LibjpegPlanes(), (True, True), None
    p._torch_dtype, p._layout = torch.uint8, "NCHW"
    p._device_transform, p._ctx = None, tmx.cpu()
    batch = p._decode_nvjpeg(
        [fx["jpeg_%d" % i].tobytes() for i in range(n)],
        [float(i) for i in range(n)],
        timg._chunk_seed(int(fx["seed"]), 0, epoch=1),
        (n, 3) + tuple(crop))
    np.testing.assert_array_equal(batch.data[0].asnumpy(), fx["batch"])
    assert batch.label[0].asnumpy().tolist() == list(range(n))


def make_nvjpeg_fixture():
    """JPEGs (4:2:0, 4:4:4, grayscale, one smaller than the crop), the JAX
    package's exact libjpeg decode of each, and its native pipe's first
    uint8 batch of them (exact IDCT, rand_crop + rand_mirror, seed 11)."""
    import cv2
    import tempfile
    rs = np.random.RandomState(21)
    specs = ((72, 96, None), (96, 72, None), (80, 80, "444"),
             (64, 70, "gray"), (30, 36, None), (100, 130, None))
    out = {"crop": np.array([48, 40], np.int64), "seed": np.array(11)}
    jpegs = []
    for i, (h, w, kind) in enumerate(specs):
        img = chip_smoke.seeded_image(rs, h, w)
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if kind == "444":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
        if kind == "gray":
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        jpegs.append(buf.tobytes())
        out["jpeg_%d" % i] = np.frombuffer(buf.tobytes(), np.uint8)
        out["pixels_%d" % i] = jimg.imdecode(buf.tobytes())
    d = tempfile.mkdtemp()
    try:
        w = jmx.recordio.MXIndexedRecordIO(d + "/f.idx", d + "/f.rec", "w")
        for i, raw in enumerate(jpegs):
            w.write_idx(i, jmx.recordio.pack((0, float(i), i, 0), raw))
        w.close()
        old = os.environ.get("MXNET_JPEG_DECODE_FAST")
        os.environ["MXNET_JPEG_DECODE_FAST"] = "0"
        try:
            it = jmx.io.ImageRecordIter(d + "/f.rec", (3, 48, 40),
                                        len(jpegs), seed=11, dtype="uint8",
                                        rand_crop=True, rand_mirror=True,
                                        preprocess_threads=1)
            out["batch"] = it.next().data[0].asnumpy()
            it.close()
        finally:
            if old is None:
                del os.environ["MXNET_JPEG_DECODE_FAST"]
            else:
                os.environ["MXNET_JPEG_DECODE_FAST"] = old
    finally:
        import shutil
        shutil.rmtree(d)
    return out


def test_nvjpeg_fixture_is_current():
    """The committed fixture is what ``make_nvjpeg_fixture`` makes, and
    under 1 MB."""
    assert os.path.getsize(FIXTURE) < 1 << 20
    fresh = make_nvjpeg_fixture()
    with np.load(FIXTURE) as f:
        assert sorted(f.files) == sorted(fresh)
        for k in fresh:
            np.testing.assert_array_equal(f[k], fresh[k], err_msg=k)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **make_nvjpeg_fixture())
    print("wrote", FIXTURE, os.path.getsize(FIXTURE))
