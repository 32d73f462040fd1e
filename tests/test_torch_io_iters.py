"""The port's iterators of ``io.py`` (``ResizeIter``, ``PrefetchingIter``,
``MNISTIter``, ``CSVIter``, ``DataBatch.release``, ``DataIter.close``),
its host dependency engine (``engine.py``, native and Python) and the
retry ladder (``resilience.retrying_next``) against the JAX package's, on
the CPU, over idx and CSV files made from seeded numpy.  Tolerance: exact
(the same arrays in the same order)."""
import struct
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as teng
from mxnet_tpu_torch import resilience as tres


def _batches(it):
    return [([d.asnumpy() for d in b.data],
             [l.asnumpy() for l in (b.label or [])], b.pad) for b in it]


def _same(a, b):
    assert len(a) == len(b)
    for (dj, lj, pj), (dt, lt, pt) in zip(a, b):
        for x, y in zip(dj + lj, dt + lt):
            np.testing.assert_array_equal(x, y)
        assert pj == pt


def _arrays(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 3).astype(np.float32), \
        rs.randint(0, 4, n).astype(np.float32)


def test_resize_iter_equal():
    X, y = _arrays()
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.ResizeIter(mod.io.NDArrayIter(X, y, batch_size=4), 5)
            outs.append(_batches(it) + (it.reset() or _batches(it)))
            assert it.provide_data[0].shape == (4, 3)
    _same(*outs)
    assert len(outs[1]) == 10


def test_prefetching_iter_order_rename_and_errors():
    X, y = _arrays(12)
    X2, _ = _arrays(12, seed=1)
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.PrefetchingIter(
                [mod.io.NDArrayIter(X, y, batch_size=4),
                 mod.io.NDArrayIter(X2, None, batch_size=4,
                                    data_name="d2")],
                rename_data=[{"data": "a"}, {"d2": "b"}])
            assert [d.name for d in it.provide_data] == ["a", "b"]
            outs.append(_batches(it) + (it.reset() or _batches(it)))
    _same(*outs)
    assert len(outs[1]) == 6 and len(outs[1][0][0]) == 2

    class Flaky(tmx.io.DataIter):
        """Fails twice with IOError at its second batch, then recovers."""

        def __init__(self):
            super().__init__(2)
            self.n = 0
            self.fails = 2

        def next(self):
            if self.n == 1 and self.fails:
                self.fails -= 1
                raise IOError("flaky")
            if self.n >= 3:
                raise StopIteration
            self.n += 1
            return tmx.io.DataBatch([self.n], None)

        def reset(self):
            self.n = 0

    it = tmx.io.PrefetchingIter(Flaky())
    assert [b.data[0] for b in it] == [1, 2, 3]     # retried through

    class Broken(Flaky):
        def next(self):
            if self.n == 1:
                raise ValueError("broken")
            return super().next()

    it = tmx.io.PrefetchingIter(Broken())
    assert it.next().data[0] == 1
    with pytest.raises(ValueError, match="broken"):
        it.next()
    it.close()


def _idx_files(tmp_path, n=9):
    rs = np.random.RandomState(2)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img"), str(tmp_path / "lab")
    with open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    return ip, lp


@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter_equal(tmp_path, flat, shuffle):
    ip, lp = _idx_files(tmp_path)
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.MNISTIter(image=ip, label=lp, batch_size=4,
                                  shuffle=shuffle, flat=flat, seed=3,
                                  silent=True)
            outs.append(_batches(it))
    _same(*outs)
    assert outs[1][0][0][0].shape == ((4, 784) if flat else (4, 1, 28, 28))
    with open(ip, "r+b") as f:
        f.write(struct.pack(">I", 7))
    with pytest.raises(tmx.MXNetError):
        tmx.io.MNISTIter(image=ip, label=lp)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_equal(tmp_path, round_batch):
    rs = np.random.RandomState(4)
    dp, lp = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dp, rs.rand(7, 6), delimiter=",")
    np.savetxt(lp, rs.randint(0, 3, (7, 1)), delimiter=",")
    outs = []
    for mod in (jmx, tmx):
        with mod.cpu():
            it = mod.io.CSVIter(data_csv=dp, data_shape=(2, 3), label_csv=lp,
                                batch_size=3, round_batch=round_batch)
            outs.append(_batches(it))
    _same(*outs)
    assert len(outs[1]) == (3 if round_batch else 2)


def test_release_and_close_are_noops():
    b = tmx.io.DataBatch([1], [2])
    b.release()
    b.release()
    it = tmx.io.NDArrayIter(np.zeros((2, 1), np.float32), batch_size=1)
    it.close()
    s = tmx.io.StagedBatch({"data": 1}, data=[1], label=[2], pad=1)
    assert s.staged == {"data": 1} and s.event is None and s.pad == 1
    assert isinstance(s, tmx.io.DataBatch)


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("engine_type", ["ThreadedEngine", "NaiveEngine"])
def test_engine_read_write_order(force_python, engine_type):
    """Writes to a var serialize in push order against reads; reads of the
    var run after the write before them; wait_for_all drains; an op's
    exception surfaces at the wait.  The same trace as the JAX engine's."""
    traces = []
    for mod in (jmx.engine, teng):
        eng = mod.Engine(engine_type, num_workers=4,
                         force_python=force_python)
        assert eng.is_native == (not force_python)
        v = eng.new_variable()
        log = []
        lock = threading.Lock()

        def op(tag, delay=0.0):
            def fn():
                time.sleep(delay)
                with lock:
                    log.append(tag)
            return fn

        eng.push(op("w1", 0.02), mutable_vars=(v,))
        for i in range(3):
            eng.push(op("r%d" % i), const_vars=(v,))
        eng.push(op("w2"), mutable_vars=(v,))
        eng.wait_for_var(v)
        eng.push(lambda: 1 / 0, mutable_vars=(v,))
        with pytest.raises(Exception, match="ZeroDivisionError"):
            eng.wait_for_all()
        eng.delete_variable(v)
        eng.wait_for_all()
        assert eng.num_pending() == 0
        eng.shutdown()
        traces.append((log[0], sorted(log[1:4]), log[4]))
    assert traces[0] == traces[1] == ("w1", ["r0", "r1", "r2"], "w2")


def test_engine_profile_dump():
    import json
    eng = teng.Engine(force_python=True)
    eng.set_profiler_state(True)
    eng.push(lambda: None, name="probe")
    eng.wait_for_all()
    trace = json.loads(eng.dump_profile())
    assert [e["name"] for e in trace["traceEvents"]] == ["probe", "probe"]
    eng.shutdown()
    assert teng.get() is teng.get()


def test_retrying_next_ladder(monkeypatch):
    monkeypatch.setenv("MXTPU_DATA_RETRY_BACKOFF", "0")

    class It(object):
        def __init__(self, fails, exc):
            self.fails, self.exc, self.calls = fails, exc, 0

        def next(self):
            self.calls += 1
            if self.fails:
                self.fails -= 1
                raise self.exc
            return "ok"

    it = It(2, OSError("disk"))
    assert tres.retrying_next(it) == "ok" and it.calls == 3
    with pytest.raises(tmx.MXNetError, match="all 3 attempts"):
        tres.retrying_next(It(3, tres.TransientError("x")))
    it = It(1, KeyError("bug"))
    with pytest.raises(KeyError):
        tres.retrying_next(it)
    assert it.calls == 1
    monkeypatch.setenv("MXTPU_DATA_RETRIES", "1")
    with pytest.raises(tmx.MXNetError, match="all 1 attempts"):
        tres.retrying_next(It(1, OSError("once")))
    sleeps = []
    with pytest.raises(tmx.MXNetError):
        tres.retry(It(5, tres.TransientError("t")).next, attempts=4,
                   backoff=0.5, max_backoff=1.0, sleep=sleeps.append)
    assert sleeps == [0.5, 1.0, 1.0]
