"""The port's RecordIO (``mxnet_tpu_torch/recordio.py`` and its native
codec) against the JAX package's: records and ``.idx`` files are byte-equal
across packages and backends in both directions, ``pack``/``unpack`` and
``pack_img``/``unpack_img`` give the same bytes and values, planned
readahead advises the same records, and the native ``im2rec`` packer writes
the same files.  Tolerance: exact everywhere (the same code on the same
bytes)."""
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import native as tnative
from mxnet_tpu_torch import recordio as trec

RECORDS = [
    b"",
    b"x",
    b"hello world",
    b"a" * 1000,
    struct.pack("<I", 0xced7230a),
    b"1234" + struct.pack("<I", 0xced7230a) + b"tail",
    struct.pack("<I", 0xced7230a) * 5,
    b"off" + struct.pack("<I", 0xced7230a),
    np.random.RandomState(0).bytes(4096),
]

BACKENDS = {
    "jax-native": (jrec._NativeRecordWriter, jrec._NativeRecordReader),
    "jax-python": (jrec._PyRecordWriter, jrec._PyRecordReader),
    "port-native": (trec._NativeRecordWriter, trec._NativeRecordReader),
    "port-python": (trec._PyRecordWriter, trec._PyRecordReader),
}


def _write(cls, path, records):
    w = cls(path)
    for r in records:
        w.write(r)
    w.close()
    with open(path, "rb") as f:
        return f.read()


def _read(cls, path):
    r = cls(path)
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


def test_native_library_loads_beside_the_jax_one():
    lib = tnative.get_lib()
    assert lib is not None and lib._has_imagedec
    assert jnative.get_lib() is not None
    assert os.path.basename(tnative.library_path()).startswith(
        "libmxt_native-")
    assert hasattr(lib, "MXTRecordIOWriterCreate")


@pytest.mark.parametrize("writer", sorted(BACKENDS))
def test_records_byte_equal_across_packages_and_backends(tmp_path, writer):
    """Each backend's file equals the JAX native writer's, and every
    backend of both packages reads it back."""
    ref = _write(BACKENDS["jax-native"][0], str(tmp_path / "ref.rec"),
                 RECORDS)
    path = str(tmp_path / "w.rec")
    assert _write(BACKENDS[writer][0], path, RECORDS) == ref
    for name, (_, reader) in sorted(BACKENDS.items()):
        assert _read(reader, path) == RECORDS, name


@pytest.mark.parametrize("key_type", [int, str])
def test_indexed_records_and_idx_equal(tmp_path, key_type):
    files = []
    for mod in (jrec, trec):
        d = tmp_path / mod.__name__
        d.mkdir()
        w = mod.MXIndexedRecordIO(str(d / "a.idx"), str(d / "a.rec"), "w",
                                  key_type=key_type)
        for i, r in enumerate(RECORDS):
            w.write_idx(key_type(i * 3), r)
        w.close()
        files.append([open(str(d / n), "rb").read()
                      for n in ("a.rec", "a.idx")])
    assert files[0] == files[1]
    d = tmp_path / "mxnet_tpu_torch.recordio"
    r = trec.MXIndexedRecordIO(str(d / "a.idx"), str(d / "a.rec"), "r",
                               key_type=key_type)
    assert r.keys == [key_type(i * 3) for i in range(len(RECORDS))]
    for i in reversed(range(len(RECORDS))):
        assert r.read_idx(key_type(i * 3)) == RECORDS[i]
    r.close()
    assert trec.read_index(str(d / "a.idx"), key_type) == \
        jrec.read_index(str(d / "a.idx"), key_type)


def test_read_plan_readahead_matches(tmp_path):
    prefix = str(tmp_path / "p")
    w = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(40):
        w.write_idx(i, bytes([i]) * (100 + i))
    w.close()
    order = list(np.random.RandomState(3).permutation(40))
    advised = []
    for mod in (jrec, trec):
        r = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
        r.set_read_plan(order, window=8)
        got = [r.read_idx(k) for k in order[:25]]
        assert got == [bytes([k]) * (100 + k) for k in order[:25]]
        r.read_idx(order[30])          # off-plan: resynchronize
        advised.append(r.readahead_advised)
        r.reset()
        assert r._ra_plan is None
        r.close()
    assert advised[0] == advised[1] > 0


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_pack_unpack_equal(label):
    header = (0, label, 7, 11)
    payload = b"payload-bytes"
    s = trec.pack(header, payload)
    assert s == jrec.pack(header, payload)
    th, tp = trec.unpack(s)
    jh, jp = jrec.unpack(s)
    assert tp == jp == payload
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_equal(fmt):
    rs = np.random.RandomState(5)
    img = (rs.rand(23, 31, 3) * 255).astype(np.uint8)
    s = trec.pack_img((0, 2.0, 1, 0), img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img((0, 2.0, 1, 0), img, quality=90, img_fmt=fmt)
    (th, ti), (jh, ji) = trec.unpack_img(s), jrec.unpack_img(s)
    assert th.label == jh.label == 2.0
    np.testing.assert_array_equal(ti, ji)
    if fmt == ".png":
        np.testing.assert_array_equal(ti, img)


def test_native_im2rec_equal(tmp_path):
    import cv2
    rs = np.random.RandomState(0)
    root = tmp_path / "imgs"
    root.mkdir()
    with open(str(tmp_path / "l.lst"), "w") as f:
        for i in range(6):
            img = (rs.rand(40 + i, 48, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / ("%d.jpg" % i)), img)
            f.write("%d\t%d\t%d.jpg\n" % (i, i % 2, i))
    outs = []
    for tag in ("j", "t"):
        rec, idx = str(tmp_path / (tag + ".rec")), str(tmp_path / (tag + ".idx"))
        if tag == "j":
            import ctypes
            packed = ctypes.c_uint64(0)
            skipped = ctypes.c_uint64(0)
            rc = jnative.get_lib().MXTPUIm2Rec(
                str(tmp_path / "l.lst").encode(), str(root).encode(),
                rec.encode(), idx.encode(), 32, 90, 2, 0,
                ctypes.byref(packed), ctypes.byref(skipped))
            assert rc == 0
            counts = (packed.value, skipped.value)
        else:
            counts = tnative.im2rec(str(tmp_path / "l.lst"), str(root), rec,
                                    idx, resize=32, quality=90, nthreads=2)
        outs.append((counts, open(rec, "rb").read(), open(idx).read()))
    assert outs[0] == outs[1]
    assert outs[1][0] == (6, 0)
    r = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "t.idx"),
                                       str(tmp_path / "t.rec"), "r")
    h, img = tmx.recordio.unpack_img(r.read_idx(3))
    assert min(img.shape[:2]) == 32 and h.label == 1.0
    r.close()


def test_no_native_selects_python_backend(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_NO_NATIVE", "1")
    w = tmx.recordio.MXRecordIO(str(tmp_path / "n.rec"), "w")
    assert isinstance(w.record, trec._PyRecordWriter)
    w.write(b"abc")
    w.close()
    assert jmx.recordio.MXRecordIO(str(tmp_path / "n.rec"), "r").read() \
        == b"abc"
