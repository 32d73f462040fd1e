"""The port's on-device augmentation (``mxnet_tpu_torch/kernels/augment.py``
``DeviceAugment``) against the JAX package's, and its route through
``ImageRecordIter(device_augment=...)``, on the CPU at 32x32, batch 8.

Tolerances: exact against the JAX package wherever no random draw is
taken (margin 0, the center crop, no mirror; mean/std, every dtype, both
layouts, pad rows); the resize branch within 1e-5 x max |out| (float32
resize weights summed in another order).  Random mode draws differently
from JAX's threefry by design: each image is held exactly against the
numpy crop and flip of its canvas at ``draws()``."""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu.kernels.augment import DeviceAugment as JAug  # noqa: E402
from mxnet_tpu_torch.data_service import common  # noqa: E402
from mxnet_tpu_torch.kernels.augment import DeviceAugment  # noqa: E402
from test_torch_data_service import (BATCH, N_IMAGES, SHAPE,  # noqa: E402
                                     assert_streams_equal, bits, kw,
                                     spawn_port_server, stop, stream,
                                     write_rec)

OUT = (3, 8, 10)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return write_rec(tmx.recordio, str(tmp_path_factory.mktemp("aug") / "d"))


def _canvas(aug, n=BATCH, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n,) + aug.per_layout(aug.canvas_shape)
                      ).astype(np.uint8)


def _as_bits(t):
    return bits(t) if isinstance(t, torch.Tensor) else bits(np.asarray(t))


EXACT_CASES = [(layout, dtype, case)
               for layout in ("NCHW", "NHWC")
               for dtype in ("float32", "uint8", "bfloat16")
               for case in ("margin0", "center16", "center16_norm",
                            "margin3_scalar_norm")
               if not (dtype == "uint8" and "norm" in case)]


@pytest.mark.parametrize("layout,dtype,case", EXACT_CASES)
def test_equals_jax_without_draws(layout, dtype, case):
    """Margin 0 (a pass-through), the center crop at margin 16, mean/std
    (ImageNet's, or scalars), no mirror; nvalid below the batch zeroes the
    pad rows in both."""
    margin = {"margin0": 0, "center16": 16, "center16_norm": 16,
              "margin3_scalar_norm": 3}[case]
    norm = {}
    if case == "center16_norm":
        norm = dict(mean=True, std=True)
    elif case == "margin3_scalar_norm":
        norm = dict(mean=117.0, std=[58.0, 57.0, 57.5])
    args = dict(margin=margin, layout=layout, dtype=dtype, **norm)
    j, t = JAug(OUT, **args), DeviceAugment(OUT, **args)
    assert t.canvas_shape == j.canvas_shape
    assert t.per_layout(t.out_shape) == j.per_layout(j.out_shape)
    x = _canvas(t)
    for nvalid in (BATCH, 5):
        a = _as_bits(j(x, 7, nvalid))
        b = _as_bits(t(torch.from_numpy(x), 7, nvalid))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        if nvalid < BATCH:
            assert not b[nvalid:].any()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("src", [(20, 17), (60, 64)])
def test_resize_branch_within_1e5_of_jax(layout, src):
    """A canvas of another size is resized first (jax.image.resize's
    linear weights, antialias on the way down)."""
    args = dict(margin=4, layout=layout, mean=True, std=True)
    j, t = JAug(OUT, **args), DeviceAugment(OUT, **args)
    shape = (3,) + src if layout == "NCHW" else src + (3,)
    x = np.random.RandomState(1).randint(0, 256, (4,) + shape).astype(
        np.uint8)
    a = np.asarray(j(x, 7, 3))
    b = t(torch.from_numpy(x), 7, 3).numpy()
    assert a.shape == b.shape == (4,) + t.per_layout(OUT)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    assert not b[3:].any()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_random_mode_is_the_numpy_crop_and_flip_of_its_draws(layout):
    aug = DeviceAugment(OUT, margin=6, rand_crop=True, rand_mirror=True,
                        mean=True, std=True, layout=layout)
    x = _canvas(aug, seed=2)
    out = aug(torch.from_numpy(x), 5, BATCH).numpy()
    d = aug.draws(5, BATCH)
    assert d.shape == (BATCH, 3)
    assert (d[:, :2] >= 0).all() and (d[:, :2] <= 6).all()
    assert set(d[:, 2]) <= {0, 1}
    mean = np.asarray(common.IMAGENET_MEAN, np.float32)
    inv = np.float32(1) / np.asarray(common.IMAGENET_STD, np.float32)
    _, h, w = OUT
    for i, (oy, ox, flip) in enumerate(d):
        img = x[i] if layout == "NHWC" else x[i].transpose(1, 2, 0)
        win = img[oy:oy + h, ox:ox + w].astype(np.float32)
        if flip:
            win = win[:, ::-1]
        ref = (win - mean) * inv
        if layout == "NCHW":
            ref = ref.transpose(2, 0, 1)
        np.testing.assert_array_equal(out[i], ref)
    # the same chunk seed reproduces; another one differs
    np.testing.assert_array_equal(aug(torch.from_numpy(x), 5, BATCH).numpy(),
                                  out)
    assert not np.array_equal(aug.draws(6, BATCH), d)
    assert not np.array_equal(aug(torch.from_numpy(x), 6, BATCH).numpy(),
                              out)
    # the draws are per image: rows differ within one batch
    assert len({tuple(r) for r in d}) > 1
    # without rand_crop the window is centered; without rand_mirror no flip
    center = DeviceAugment(OUT, margin=6, rand_mirror=True, layout=layout)
    dc = center.draws(5, 64)
    assert (dc[:, :2] == 3).all() and set(dc[:, 2]) == {0, 1}


def test_validation_matches_jax():
    for bad in (dict(data_shape=(1, 8, 8)), dict(layout="HWC"),
                dict(margin=-1), dict(dtype="float16"),
                dict(dtype="uint8", mean=True), dict(mean=[1.0, 2.0])):
        args = dict(data_shape=OUT)
        args.update(bad)
        shape = args.pop("data_shape")
        with pytest.raises(Exception) as je:
            JAug(shape, **args)
        with pytest.raises(tmx.MXNetError) as te:
            DeviceAugment(shape, **args)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the route: ImageRecordIter(data_service=..., device_augment=...)
# ---------------------------------------------------------------------------

DEV_KW = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
              host_batches=False)


def _canvas_stream(rec, epochs):
    """The service's uint8 canvases (what device_augment ships)."""
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, data_shape=(3, 48, 48),
                                         dtype="uint8", data_service=True,
                                         preprocess_threads=2))
        out = stream(it, epochs)
        it.close()
    return out


def test_device_augment_stream_is_the_augment_of_the_canvases(rec):
    """w1 and w3 streams equal over two epochs; each batch is
    DeviceAugment of the canvas the service decodes, at the batch's chunk
    seed; the shape is the post-augment one and the pad rows are zero."""
    streams = []
    for workers in (1, 3):
        with tmx.cpu():
            it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=workers,
                                             data_service=True,
                                             device_augment=True, **DEV_KW))
            assert it._dev_aug is not None and it._dev_aug.margin == 16
            assert it._service._shape == (3, 48, 48)
            assert it._service._dtype == "uint8"
            assert it.provide_data[0].shape == (BATCH,) + SHAPE
            streams.append(stream(it, 2))
            assert it._dev_aug.calls == 10
            it.close()
    assert_streams_equal(streams[0], streams[1], "device-aug w1-vs-w3")
    got = streams[0]
    pad = got[4][2]
    assert pad == BATCH - N_IMAGES % BATCH
    assert not got[4][0][-pad:].any()
    aug = DeviceAugment(SHAPE, margin=16, rand_crop=True, rand_mirror=True,
                        mean=True, std=True)
    for i, (canvas, label, p) in enumerate(_canvas_stream(rec, 2)):
        epoch, g = 1 + i // 5, i % 5
        ref = aug(torch.from_numpy(canvas), common.chunk_seed(11, g, epoch),
                  BATCH - p).numpy()
        np.testing.assert_array_equal(got[i][0], ref, err_msg="batch %d" % i)
        np.testing.assert_array_equal(got[i][1], label)


def test_device_augment_requires_service_and_no_host_batches(rec):
    with tmx.cpu():
        with pytest.raises(tmx.MXNetError, match="device_augment"):
            tmx.io.ImageRecordIter(preprocess_threads=1, device_augment=True,
                                   **kw(rec))
        with pytest.raises(tmx.MXNetError, match="host_batches"):
            tmx.io.ImageRecordIter(preprocess_threads=1, data_service=True,
                                   device_augment=True, **kw(rec))


def test_device_augment_zero_margin_engages_and_false_opts_out(rec):
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, shuffle=False,
                                         preprocess_threads=1,
                                         data_service=True,
                                         device_augment=0, rand_mirror=True,
                                         host_batches=False))
        assert it._dev_aug is not None and it._dev_aug.margin == 0
        assert it.next().data[0].shape == (BATCH,) + SHAPE
        it.close()
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1,
                                         data_service=True,
                                         device_augment=False,
                                         host_batches=False))
        assert it._dev_aug is None
        it.close()


def test_seam_off_restores_the_exact_host_path(rec, monkeypatch):
    """MXTPU_FUSED_KERNELS=0 with device_augment gives the host-augmented
    stream bit for bit; with the seam on the product differs."""
    over = dict(rand_crop=True, rand_mirror=True, host_batches=False,
                data_service=True, preprocess_threads=2)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, **over))
        ref = stream(it)
        it.close()
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", "0")
        it = tmx.io.ImageRecordIter(**kw(rec, device_augment=True, **over))
        assert it._dev_aug is None
        off = stream(it)
        it.close()
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", "1")
        it = tmx.io.ImageRecordIter(**kw(rec, device_augment=True, **over))
        on = stream(it)
        it.close()
    assert_streams_equal(ref, off, "seam-off-vs-host")
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(ref, on))


def test_network_tier_device_augment_equals_local(rec, tmp_path):
    """Two loopback servers with 2 workers each and device_augment give
    the local service's device-augmented stream."""
    procs, addrs = [], []
    for n in range(2):
        p, a = spawn_port_server(tmp_path, n)
        procs.append(p)
        addrs.append(a)
    try:
        streams = []
        for ds in (True, ",".join(addrs)):
            with tmx.cpu():
                it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=2,
                                                 data_service=ds,
                                                 device_augment=True,
                                                 **DEV_KW))
                assert it.route == ("service" if ds is True else "network")
                streams.append(stream(it, 2))
                it.close()
    finally:
        stop(procs)
    assert_streams_equal(streams[0], streams[1], "local-vs-net device-aug")
