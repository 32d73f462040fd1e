"""The port's data service (``mxnet_tpu_torch/data_service/``) against the
JAX package's, on the CPU at 32x32, batch 8, over a 37-image ``.rec`` (an
odd count: the final batch is padded).

- ``common``: epoch orders, shards, strided shards, seeds and slot layouts
  equal the JAX package's element for element.
- The ring's seqlock rejects unpublished and stale slots; stop and stall
  are accounted.
- Streams: byte-equal at 1 and 3 workers, and byte-equal to the JAX
  package's ``DataService`` on the same ``.rec`` (both decode with the same
  ``imagedec.cc`` here; bfloat16 compares as bits), with and without
  seeded augmentation; the cv2 decoder of the port's worker equals the JAX
  package's on the same raws and seed.
- Routing through ``ImageRecordIter`` and ``MXTPU_DATA_WORKERS``, the
  slot lifetime of the upload, ``DevicePrefetchIter`` over a slot-backed
  iterator.
- The network tier on loopback: the local stream, a mid-epoch seek, bad
  servers and configs, and the wire against the JAX package's server and
  consumer in both directions.
- Robustness without fault points: a SIGKILLed worker, a SIGSTOPped worker
  under ``MXTPU_DATA_HEARTBEAT_S=2``, a SIGKILLed server.
- A ResNet-8 ``Module.fit`` fed by ``ImageRecordIter(data_service=True)``
  against the JAX package's at rtol 1e-4 / atol 1e-5 (float32
  convolutions and BatchNorm sums in another order, carried through the
  updates), fed host-augmented.

Tolerance: exact everywhere else."""
import importlib.util
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from conftest import spawn_data_server  # noqa: E402
from mxnet_tpu.data_service import common as jcommon  # noqa: E402
from mxnet_tpu_torch.data_service import common  # noqa: E402
from mxnet_tpu_torch.data_service.ring import Ring  # noqa: E402

SHAPE = (3, 32, 32)
BATCH = 8
N_IMAGES = 37
SERVER_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "data_service",
                           "server_main.py")


def write_rec(recordio, prefix, n=N_IMAGES, seed=0, size=64):
    rs = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        img = chip_smoke.seeded_image(rs, size, size + 4 * (i % 3))
        w.write_idx(i, recordio.pack_img((0, float(i % 5), i, 0), img,
                                         quality=90))
    w.close()
    return prefix + ".rec", prefix + ".idx"


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return write_rec(tmx.recordio, str(tmp_path_factory.mktemp("ds") / "d"))


def bits(a):
    """A batch array as comparable numpy (bfloat16 as its bits)."""
    if isinstance(a, tmx.nd.NDArray):
        a = a._data
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16).copy()
        return a.numpy().copy()
    if hasattr(a, "asnumpy"):
        a = a.asnumpy()
    a = np.array(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def stream(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((bits(b.data[0]), bits(b.label[0]), b.pad))
    return out


def assert_streams_equal(a, b, what):
    assert len(a) == len(b), (what, len(a), len(b))
    for i, ((d1, l1, p1), (d2, l2, p2)) in enumerate(zip(a, b)):
        assert p1 == p2, (what, i, "pad", p1, p2)
        assert d1.dtype == d2.dtype and d1.shape == d2.shape, (what, i)
        np.testing.assert_array_equal(l1, l2, err_msg="%s batch %d labels"
                                      % (what, i))
        np.testing.assert_array_equal(d1, d2, err_msg="%s batch %d data"
                                      % (what, i))


def kw(rec, **over):
    out = dict(path_imgrec=rec[0], path_imgidx=rec[1], data_shape=SHAPE,
               batch_size=BATCH, shuffle=True, seed=11, dtype="float32",
               host_batches=True, prefetch_buffer=2)
    out.update(over)
    return out


def iter_stream(mx, rec, epochs=1, **over):
    with mx.cpu():
        it = mx.io.ImageRecordIter(**kw(rec, **over))
        try:
            return stream(it, epochs), it.stats()
        finally:
            it.close()


def native_decoder():
    lib = tmx.native.get_lib()
    return "native" if lib is not None and lib._has_imagedec else "python"


def spawn_port_server(tmp_path, n, port=0, extra_env=None):
    """One port server (``server_main.py``) on a loopback port:
    ``(proc, 'host:port')``."""
    pf = str(tmp_path / ("portds%d-%d" % (n, port)))
    if os.path.exists(pf):
        os.remove(pf)
    env = dict(os.environ)
    env.update(extra_env or {})
    proc = subprocess.Popen([sys.executable, SERVER_MAIN, "--port",
                             str(port), "--port-file", pf],
                            stderr=subprocess.DEVNULL, env=env)
    deadline = time.monotonic() + 30
    while not os.path.exists(pf):
        assert proc.poll() is None, "server died at startup"
        assert time.monotonic() < deadline, "server did not come up"
        time.sleep(0.05)
    with open(pf) as f:
        return proc, f.read().strip()


def stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(1, 1), (23, 4), (37, 8), (100, 8),
                                  (64, 16)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_orders_and_shards_equal_jax(n, bs, shuffle):
    keys = list(range(100, 100 + n))
    for parts in ((0, 1), (1, 2)):
        a = common.EpochOrder(keys, 7, shuffle, *parts)
        b = jcommon.EpochOrder(keys, 7, shuffle, *parts)
        for epoch in (1, 2, 3, 2, 5):
            oa, ob = list(a.seek(epoch)), list(b.seek(epoch))
            assert oa == ob
            assert common.epoch_order(keys, 7, epoch, shuffle, *parts) == \
                jcommon.epoch_order(keys, 7, epoch, shuffle, *parts)
            nb = common.num_batches(len(oa), bs)
            assert nb == jcommon.num_batches(len(oa), bs)
            for S, W in ((1, 1), (1, 3), (2, 2), (3, 2)):
                for s in range(S):
                    assert common.stream_batches(nb, s, S) == \
                        jcommon.stream_batches(nb, s, S)
                    for w in range(W):
                        assert common.worker_batches(oa, bs, w, W, s, S) == \
                            jcommon.worker_batches(ob, bs, w, W, s, S)
            for g in range(nb):
                assert common.chunk_seed(7, g, epoch) == \
                    jcommon.chunk_seed(7, g, epoch)


def test_slot_layouts_constants_and_augs_equal_jax():
    for name in ("CTRL_WORDS", "CTRL_HEAD", "CTRL_TAIL", "CTRL_HB_MS",
                 "CTRL_ACK_EPOCH", "CTRL_STALL_MS", "CTRL_ABORT_EPOCH",
                 "CTRL_STOP", "CTRL_BATCHES", "SLOT_HDR_WORDS", "HDR_SEQ",
                 "HDR_BATCH_IDX", "HDR_NVALID", "HDR_EPOCH",
                 "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(common, name) == getattr(jcommon, name), name
    # the decoder word is one the JAX package's header leaves unused
    assert common.HDR_DECODER >= 4 and common.HDR_DECODER < \
        common.SLOT_HDR_WORDS
    for bs in (1, 7, 8, 32):
        for shape in ((3, 32, 32), (32, 32, 3), (3, 240, 240)):
            for lw in (1, 4):
                for dt in ("uint8", "float32", "bfloat16"):
                    isz = common.np_dtype(dt).itemsize
                    assert isz == jcommon.np_dtype(dt).itemsize
                    for sb in (None, 0, 1 << 20):
                        assert common.slot_layout(bs, shape, lw, isz, sb) \
                            == jcommon.slot_layout(bs, shape, lw, isz, sb)
    aug = {"mean": True, "std": np.array([1.0, 2.0, 3.0], np.float32),
           "rand_crop": True, "resize": 40}
    assert common.jsonable_aug(aug) == jcommon.jsonable_aug(aug)
    x = np.random.RandomState(0).standard_normal(1000).astype(np.float32)
    x[:3] = [np.inf, -np.inf, 0.0]
    import ml_dtypes
    np.testing.assert_array_equal(common.float_to_bf16_bits(x),
                                  x.astype(ml_dtypes.bfloat16).view(
                                      np.uint16))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_ring_seqlock_rejects_unpublished_and_stale_slots():
    ring = Ring("mxtds-test-%d" % os.getpid(), slots=2, batch_size=2,
                data_shape=(3, 4, 4), label_width=1, itemsize=4,
                create=True)
    try:
        assert not ring.ready(0) and ring.decoder() == 0
        ring.announce_decoder(1)      # the worker's decoder, at its start
        assert ring.decoder() == 1
        s = ring.acquire()
        ring.begin_write(s, 0)
        assert not ring.ready(0)   # odd seq: write in progress
        assert not ring.published_mismatch(0, 1)
        ring.data_view(s, np.float32)[:] = 1.5
        ring.label_view(s)[:] = 7.0
        ring.commit(s, 0, 2, 1)
        assert ring.ready(0) and ring.ready(0, 1) and not ring.ready(1)
        assert not ring.ready(0, 2)   # another epoch's slot
        assert ring.published_mismatch(1, 1)
        hdr, lab, dat = ring.peek(np.float32)
        assert int(hdr[common.HDR_NVALID]) == 2
        assert int(hdr[common.HDR_DECODER]) == 1
        assert float(dat[0, 0, 0, 0]) == 1.5 and float(lab[0, 0]) == 7.0
        ring.release()
        assert not ring.ready(0)   # consumed: the same seq is now stale
        for i in (1, 2):
            s = ring.acquire()
            ring.begin_write(s, i)
            ring.commit(s, i, 2, 1)
        assert ring.occupancy() == 2
        assert ring.acquire(on_wait=lambda: True) is None   # full
        assert ring.batches_produced() == 3
    finally:
        ring.close()


def test_ring_stop_and_stall_accounting():
    ring = Ring("mxtds-test2-%d" % os.getpid(), slots=2, batch_size=1,
                data_shape=(1,), label_width=1, itemsize=1, create=True)
    try:
        for i in range(2):
            s = ring.acquire()
            ring.begin_write(s, i)
            ring.commit(s, i, 1, 1)
        t0 = time.monotonic()
        waits = []

        def give_up():
            waits.append(1)
            return time.monotonic() - t0 > 0.05
        assert ring.acquire(poll_s=0.005, on_wait=give_up) is None
        assert ring.producer_stall_s() >= 0.04 and len(waits) > 2
        ring.request_stop()
        assert ring.acquire() is None
        assert ring.heartbeat_age_s() < 5.0
        ring.reset_counters()
        assert ring.occupancy() == 0 and not ring.stopped()
    finally:
        ring.close()


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

STREAMS = {
    "float32": dict(),
    "augmented": dict(rand_crop=True, rand_mirror=True, seed=3),
    "uint8_nhwc": dict(dtype="uint8", layout="NHWC", rand_mirror=True),
    "bfloat16": dict(dtype="bfloat16", rand_crop=True, mean=True,
                     std=True),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_equals_jax_service_and_any_worker_count(rec, name):
    """Two epochs: the port at 1 and 3 workers against the JAX package's
    service at 2, byte for byte."""
    over = STREAMS[name]
    ref, _ = iter_stream(jmx, rec, 2, data_service=True,
                         preprocess_threads=2, **over)
    one, st = iter_stream(tmx, rec, 2, data_service=True,
                          preprocess_threads=1, **over)
    three, _ = iter_stream(tmx, rec, 2, data_service=True,
                           preprocess_threads=3, **over)
    assert_streams_equal(ref, one, "jax-vs-port-w1")
    assert_streams_equal(one, three, "w1-vs-w3")
    assert ref[4][2] == BATCH - N_IMAGES % BATCH   # padded final batch
    assert st["decoders"] == [native_decoder()]


def test_python_decoder_stream_equals_jax(rec, monkeypatch):
    """Without the native library both packages' workers decode with cv2:
    the streams stay equal, and the workers say so in stats()."""
    monkeypatch.setenv("MXNET_NO_NATIVE", "1")
    over = dict(rand_crop=True, rand_mirror=True, mean=True, std=True,
                dtype="bfloat16")
    ref, _ = iter_stream(jmx, rec, data_service=True, preprocess_threads=1,
                         **over)
    got, st = iter_stream(tmx, rec, data_service=True, preprocess_threads=2,
                          **over)
    assert_streams_equal(ref, got, "python-decoder")
    assert st["decoders"] == ["python"]
    assert {w["decoder"] for w in st["workers"].values()} == {"python"}


def _load_jax_worker_main():
    path = os.path.join(REPO, "mxnet_tpu", "data_service", "_worker_main.py")
    spec = importlib.util.spec_from_file_location("jax_worker_main", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_python_decoder_equals_jax(rec, dtype, layout):
    """The cv2 decoders of both workers on the same raws and chunk seed;
    bfloat16 rounds to nearest even (ml_dtypes' bits)."""
    from mxnet_tpu_torch.data_service import _worker_main as pw
    jw = _load_jax_worker_main()
    r = tmx.recordio.MXIndexedRecordIO(rec[1], rec[0], "r")
    raws = [tmx.recordio.unpack(r.read_idx(k))[1] for k in range(6)]
    r.close()
    raws.insert(2, b"\xff\xd8 not a jpeg")
    aug = common.jsonable_aug({"rand_crop": True, "rand_mirror": True,
                               "mean": None if dtype == "uint8" else True,
                               "std": None if dtype == "uint8" else True,
                               "resize": 40})
    cfg = {"aug": aug, "data_shape": list(SHAPE), "layout": layout,
           "dtype": dtype, "dtype_code": common.DTYPE_CODES[dtype]}
    ring_shape = SHAPE if layout == "NCHW" else (32, 32, 3)
    outs = []
    for mod, C in ((pw, common), (jw, jcommon)):
        out = np.zeros((8,) + ring_shape, C.np_dtype(dtype))
        valid = np.zeros(8, np.uint8)
        nv = mod._PythonDecoder(C, dict(cfg)).decode(raws, out, valid, 1234)
        outs.append((nv, valid.copy(), bits(out)))
    assert outs[0][0] == outs[1][0] == 6
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_service_device_arrays_do_not_alias_slots(rec, monkeypatch):
    """The upload copies the slot before releasing it: an uploaded batch
    is unchanged after the ring wraps (more pulls than its 2 slots)."""
    monkeypatch.setenv("MXTPU_DATA_RING_SLOTS", "2")
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, shuffle=False,
                                         host_batches=False,
                                         preprocess_threads=1,
                                         data_service=True))
        assert it._service is not None
        first = it.next()
        snap = first.data[0].asnumpy().copy()
        for _ in range(5):
            try:
                it.next()
            except StopIteration:
                it.reset()
        np.testing.assert_array_equal(first.data[0].asnumpy(), snap)
        it.close()


def test_host_views_recycle_and_copy_is_private(rec, monkeypatch):
    """copy=False views alias ring slots (rewritten once the slot is
    recycled); DataServiceIter's default copy=True hands out private
    tensors."""
    from mxnet_tpu_torch.data_service import DataServiceIter
    monkeypatch.setenv("MXTPU_DATA_RING_SLOTS", "2")
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, shuffle=False,
                                         preprocess_threads=1,
                                         data_service=True))
        b0 = it.next()
        view = b0.data[0]
        assert isinstance(view, torch.Tensor)
        before = view.clone()
        changed = False
        for _ in range(3):
            it.next()
            if not torch.equal(view, before):
                changed = True
                break
        assert changed, "the zero-copy view was never recycled"
        it.close()
    svc = DataServiceIter(path_imgrec=rec[0], path_imgidx=rec[1],
                          data_shape=SHAPE, batch_size=BATCH, num_workers=1,
                          dtype="bfloat16")
    b0 = svc.next()
    keep = b0.data[0]
    assert keep.dtype == torch.bfloat16 and "release" not in b0.__dict__
    snap = keep.clone()
    for _ in range(3):
        svc.next()
    assert torch.equal(keep, snap)
    assert svc.provide_data[0].shape == (BATCH,) + SHAPE
    svc.close()


def test_stats_surface(rec):
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=2,
                                         data_service=True))
        assert it.route == "service"
        stream(it)
        st = it.stats()
        it.close()
    assert st["num_workers"] == 2 and st["batches_produced"] == 5
    assert set(st["workers"]) == {0, 1}
    for w in st["workers"].values():
        assert w["alive"] and w["respawns"] == 0
        assert w["producer_stall_s"] >= 0.0
        assert w["decoder"] == native_decoder()
    assert it.stats() == st                 # the final snapshot after close
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1))
        assert it.stats() is None and it.route == "native"
        it.close()


def test_service_composes_with_device_prefetch(rec):
    """DataServiceIter(copy=False) through DevicePrefetchIter: the
    prefetcher snapshots each slot-backed batch on its thread and releases
    the slot before running ahead, so a 2-slot ring that wraps under it
    delivers the uncorrupted stream."""
    from mxnet_tpu_torch.data_service import DataServiceIter
    svc = DataServiceIter(path_imgrec=rec[0], path_imgidx=rec[1],
                          data_shape=SHAPE, batch_size=BATCH, num_workers=2,
                          shuffle=True, seed=11, copy=False, slots=2)
    direct = DataServiceIter(path_imgrec=rec[0], path_imgidx=rec[1],
                             data_shape=SHAPE, batch_size=BATCH,
                             num_workers=1, shuffle=True, seed=11)
    pf = tmx.DevicePrefetchIter(svc, stage=None, depth=2)
    got = [(bits(b.data[0]), bits(b.label[0]), b.pad) for b in list(pf)]
    assert_streams_equal(stream(direct), got, "prefetch-composition")
    pf.close()
    svc.close()
    direct.close()


def test_strip_faults_env():
    from mxnet_tpu.resilience import strip_faults_env as jstrip
    from mxnet_tpu_torch.resilience import strip_faults_env
    for value, points in (("data_worker:1,ckpt_write:2@1",
                           ("data_worker", "hang_data_worker")),
                          ("hang_data_worker:1", ("hang_data_worker",)),
                          (None, ("x",)), (" a:1 , b:2 ", ("c",))):
        assert strip_faults_env(value, points) == jstrip(value, points)
    assert strip_faults_env(" a:1 , b:2 ", ("a",)) == "b:2"


def test_respawn_budget_exhausts(rec, tmp_path):
    """A worker that dies on every attempt (a truncated .rec) raises an
    MXNetError naming the budget instead of respawning forever."""
    import shutil
    bad_rec, bad_idx = str(tmp_path / "bad.rec"), str(tmp_path / "bad.idx")
    shutil.copy(rec[1], bad_idx)
    with open(rec[0], "rb") as f:
        blob = f.read()
    with open(bad_rec, "wb") as f:
        f.write(blob[:200])
    with tmx.cpu():
        with pytest.raises(tmx.MXNetError, match="respawn budget"):
            it = tmx.io.ImageRecordIter(**kw((bad_rec, bad_idx),
                                             preprocess_threads=1,
                                             data_service=True))
            stream(it)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_env_var_routes_and_explicit_forms(rec, monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_WORKERS", "2")
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1))
        assert it._service is not None and it._service.num_workers == 2
        assert it.route == "service"
        it.close()
        # the explicit opt-out wins over the variable
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1,
                                         data_service=False))
        assert it._service is None and it.route == "native"
        it.close()
        # an explicit data_service=True (or 1) sizes from the call
        for ds in (True, 1):
            it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=3,
                                             data_service=ds))
            assert it._service.num_workers == 3
            it.close()


def test_env_routing_falls_back_when_ineligible(rec, monkeypatch, caplog):
    """MXTPU_DATA_WORKERS on an ineligible iterator (no .idx, the
    example's pad, an aug_list) falls back with the JAX package's warning;
    an explicit data_service=True raises."""
    monkeypatch.setenv("MXTPU_DATA_WORKERS", "2")
    k = kw(rec, host_batches=False)
    k.pop("path_imgidx")
    with tmx.cpu():
        for extra in ({}, {"pad": 0}):
            caplog.clear()
            it = tmx.io.ImageRecordIter(preprocess_threads=1, **k, **extra)
            assert it._service is None
            assert it.route == ("native" if not extra else "process")
            assert "cannot route through the data service" in caplog.text
            it.close()
        with pytest.raises(tmx.MXNetError, match="path_imgidx"):
            tmx.io.ImageRecordIter(preprocess_threads=1, data_service=True,
                                   **k)
        with pytest.raises(tmx.MXNetError, match="augmentations"):
            tmx.io.ImageRecordIter(preprocess_threads=1, data_service=True,
                                   brightness=0.4, **kw(rec))
        with pytest.raises(tmx.MXNetError, match="aug_list"):
            tmx.io.ImageRecordIter(preprocess_threads=1, data_service=True,
                                   aug_list=[tmx.image.CastAug()],
                                   **kw(rec, host_batches=False))


def test_non_jpeg_rec_is_ineligible(tmp_path, monkeypatch):
    import cv2
    rec, idx = str(tmp_path / "png.rec"), str(tmp_path / "png.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(0)
    for i in range(9):
        ok, buf = cv2.imencode(".png", chip_smoke.seeded_image(rs, 40, 40))
        w.write_idx(i, tmx.recordio.pack((0, float(i), i, 0),
                                         buf.tobytes()))
    w.close()
    with tmx.cpu():
        with pytest.raises(tmx.MXNetError, match="JPEG"):
            tmx.io.ImageRecordIter(preprocess_threads=1, data_service=True,
                                   **kw((rec, idx)))
        monkeypatch.setenv("MXTPU_DATA_WORKERS", "2")
        it = tmx.io.ImageRecordIter(preprocess_threads=1,
                                    **kw((rec, idx), host_batches=False))
        assert it._service is None   # fell back, still serves the data
        assert it.next().data[0].shape == (BATCH,) + SHAPE
        it.close()


def test_resnet8_fit_from_service_matches_jax(tmp_path, monkeypatch):
    """ResNet-8 Module.fit (the fused route, kvstore='tpu') fed by each
    package's ImageRecordIter(data_service=True), host-augmented, from one
    seeded .rec: outputs and final parameters within rtol 1e-4 / atol
    1e-5."""
    from test_torch_dataflow import (ATOL, BATCH as B, IMAGE, RTOL, _fit,
                                     _weights)
    monkeypatch.setenv("MXTPU_METRIC_BLOCKING", "1")
    prefix = str(tmp_path / "r")
    chip_smoke.write_seeded_rec(tmx.recordio, prefix, 3 * B, 20, seed=3,
                                classes=10)
    args, aux = _weights()
    k = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
             batch_size=B, data_shape=IMAGE, rand_crop=True,
             rand_mirror=True, seed=5, mean=True, std=True,
             data_service=True, preprocess_threads=2)
    for kvstore in ("tpu",):
        results = []
        for mx in (jmx, tmx):
            with mx.cpu():
                it = mx.io.ImageRecordIter(**k)
                assert it._service is not None
                results.append(_fit(mx, it, args, aux, kvstore, mx.cpu()))
                it.close()
        (jo, ja, jx), (to, ta, tx) = results
        assert len(jo) == len(to) == 3
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        for k_ in ja:
            np.testing.assert_allclose(ta[k_], ja[k_], rtol=RTOL, atol=ATOL,
                                       err_msg=k_)
        for k_ in jx:
            np.testing.assert_allclose(tx[k_], jx[k_], rtol=RTOL, atol=ATOL,
                                       err_msg=k_)


# ---------------------------------------------------------------------------
# the network tier
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_servers(tmp_path):
    procs, addrs = [], []
    for n in range(2):
        p, a = spawn_port_server(tmp_path, n)
        procs.append(p)
        addrs.append(a)
    yield ",".join(addrs)
    stop(procs)


def test_net_tier_equals_local_stream(rec, port_servers):
    """Two loopback port servers (1 worker each) give the local service's
    stream over two epochs, the padded final batch included; the list
    form routes too."""
    over = dict(rand_crop=True, rand_mirror=True)
    ref, _ = iter_stream(tmx, rec, 2, data_service=True,
                         preprocess_threads=2, **over)
    got, st = iter_stream(tmx, rec, 2, data_service=port_servers,
                          preprocess_threads=1, **over)
    assert_streams_equal(ref, got, "local-vs-net")
    assert st["num_servers"] == 2
    assert all(s["alive"] and s["reconnects"] == 0
               for s in st["servers"].values())
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1,
                                         host_batches=False,
                                         data_service=port_servers.split(
                                             ",")))
        assert it.route == "network"
        dev = stream(it)
        it.close()
    assert_streams_equal(iter_stream(tmx, rec, data_service=True,
                                     preprocess_threads=1)[0], dev,
                         "net-device-route")


def test_net_seek_resumes_mid_epoch(rec, port_servers):
    from mxnet_tpu_torch.data_service import DataServiceIter
    from mxnet_tpu_torch.data_service.net import NetDataService

    def svc():
        return NetDataService(port_servers, rec[0], rec[1], SHAPE, BATCH,
                              shuffle=True, seed=11)

    ref_it = DataServiceIter(svc())
    ref = stream(ref_it)
    ref_it.close()
    resumed = svc()
    resumed.seek(1, 2)              # the first 2 global batches consumed
    it = DataServiceIter(resumed)
    got = stream(it)
    st = resumed.stats()
    it.close()
    assert_streams_equal(ref[2:], got, "seek-resume")
    assert all(s["reconnects"] == 0 for s in st["servers"].values()), st


def test_net_env_var_routes(rec, port_servers, monkeypatch):
    from mxnet_tpu_torch.data_service.net import NetDataService
    monkeypatch.setenv("MXTPU_DATA_SERVERS", port_servers)
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1))
        assert isinstance(it._service, NetDataService)
        it.close()
        it = tmx.io.ImageRecordIter(**kw(rec, preprocess_threads=1,
                                         data_service=True))
        assert it._service is not None and \
            not isinstance(it._service, NetDataService)
        it.close()


def test_net_rejects_bad_server_and_bad_config(rec, tmp_path):
    from mxnet_tpu_torch.data_service.net import NetDataService, \
        parse_servers
    with pytest.raises(tmx.MXNetError, match="unreachable"):
        NetDataService("127.0.0.1:1", rec[0], rec[1], SHAPE, BATCH,
                       retries=2, reconnect_s=0.05)
    for bad in ("", "nohostport", ","):
        with pytest.raises(tmx.MXNetError):
            parse_servers(bad)
    assert parse_servers("a:1;b:2") == [("a", 1), ("b", 2)]
    with pytest.raises(tmx.MXNetError, match="dtype"):
        NetDataService("127.0.0.1:1", rec[0], rec[1], SHAPE, BATCH,
                       dtype="float16")
    proc, addr = spawn_port_server(tmp_path, 8)
    try:
        with pytest.raises(tmx.MXNetError, match="rejected"):
            NetDataService(addr, "/nonexistent/x.rec", "/nonexistent/x.idx",
                           SHAPE, BATCH)
    finally:
        stop([proc])


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_wire_is_shared_with_jax(rec, tmp_path, direction):
    """The frame and handshake are a contract: the port's consumer reads
    the JAX package's tools/data_server.py and the JAX package's consumer
    reads the port's server, with the local service's bytes."""
    over = dict(rand_crop=True, rand_mirror=True, dtype="bfloat16")
    ref, _ = iter_stream(tmx, rec, data_service=True, preprocess_threads=1,
                         **over)
    if direction == "port_reads_jax":
        proc, addr = spawn_data_server(tmp_path, 5)
        mx = tmx
    else:
        proc, addr = spawn_port_server(tmp_path, 5)
        mx = jmx
    try:
        got, st = iter_stream(mx, rec, data_service=addr,
                              preprocess_threads=2, **over)
    finally:
        stop([proc])
    assert_streams_equal(ref, got, direction)
    assert st["num_servers"] == 1


# ---------------------------------------------------------------------------
# robustness, with real signals and no fault points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sig", ["SIGKILL", "SIGSTOP"])
def test_worker_signal_respawns_and_stream_intact(rec, monkeypatch, sig):
    """SIGKILL (seen by Popen.poll) or SIGSTOP under
    MXTPU_DATA_HEARTBEAT_S=2 (seen by heartbeat age) one of two workers
    after the first batch: it is respawned (in this epoch when the
    collector waits on it, else at the reset or in the next epoch), its
    old command pipe is closed, and both epochs equal an undisturbed
    run."""
    over = dict(rand_crop=True, rand_mirror=True, preprocess_threads=2,
                data_service=True)
    ref, _ = iter_stream(tmx, rec, 2, **over)
    if sig == "SIGSTOP":
        monkeypatch.setenv("MXTPU_DATA_HEARTBEAT_S", "2")
    t0 = time.monotonic()
    with tmx.cpu():
        it = tmx.io.ImageRecordIter(**kw(rec, **over))
        got = []
        for n, b in enumerate(it):
            got.append((bits(b.data[0]), bits(b.label[0]), b.pad))
            if n == 0:
                victims = it._service.worker_pids()
                assert len(victims) == 2
                old = it._service._workers[1].proc
                os.kill(victims[1], getattr(signal, sig))
        it.reset()
        got += stream(it)
        st = it.stats()
        it.close()
    # the victim was respawned (a loaded host may also age out a slow
    # start at 2 s: the stream must stay intact either way)
    assert st["workers"][1]["respawns"] >= 1, st
    assert old.stdin.closed           # the respawn leaked no pipe
    assert time.monotonic() - t0 < 60
    assert_streams_equal(ref, got, sig)


def test_server_sigkill_reconnects_and_resumes(rec, tmp_path, monkeypatch):
    """SIGKILL port server 0 after the second batch; its "supervisor"
    (this test) respawns it on the same port; the consumer evicts the dead
    connection (in this epoch, or in the next one when server 0's frames
    of this epoch were already received), resumes at the last consumed
    batch, and both epochs equal an undisturbed run."""
    monkeypatch.setenv("MXTPU_DATA_NET_TIMEOUT_S", "5")
    monkeypatch.setenv("MXTPU_DATA_NET_RECONNECT_S", "0.25")
    monkeypatch.setenv("MXTPU_DATA_NET_RETRIES", "60")
    p0, addr0 = spawn_port_server(tmp_path, 0)
    p1, addr1 = spawn_port_server(tmp_path, 1)
    procs = [p0, p1]
    servers = "%s,%s" % (addr0, addr1)
    over = dict(rand_crop=True, rand_mirror=True, preprocess_threads=1,
                data_service=servers)
    try:
        ref, _ = iter_stream(tmx, rec, 2, **over)
        with tmx.cpu():
            it = tmx.io.ImageRecordIter(**kw(rec, **over))
            got = []
            for n, b in enumerate(it):
                got.append((bits(b.data[0]), bits(b.label[0]), b.pad))
                if n == 1:
                    os.kill(p0.pid, signal.SIGKILL)
                    p0.wait()
                    procs[0], new = spawn_port_server(
                        tmp_path, 0, port=int(addr0.rsplit(":", 1)[1]))
                    assert new == addr0
            it.reset()
            got += stream(it)
            st = it.stats()
            it.close()
    finally:
        stop(procs)
    assert sum(s["reconnects"] for s in st["servers"].values()) >= 1, st
    assert_streams_equal(ref, got, "server-kill")
