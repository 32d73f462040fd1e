"""The PyTorch port stands alone: no module of ``mxnet_tpu_torch`` and no
line of ``chip_smoke.py`` imports JAX or the JAX package, the port
imports, builds a model and takes an ``SPMDTrainer`` step of a ResNet and
of the LSTM language model, a ``make_step`` step of the long-context LM
(flash route), a ``Module.fit`` through an rtc op on both Module routes,
one FGSM step in NDArray arithmetic, and the extension surface
(autograd, a CustomOp, a Monitor, the torch bridge, the mirror mode) and
the input pipeline (a ``.rec``, the three ``ImageRecordIter`` routes,
``DevicePrefetchIter`` into a step) on the CPU with JAX made
unimportable, the data service's worker, coordinator and server stream an
epoch with torch and JAX both unimportable, and the chip smoke test
refuses to run without CUDA."""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    pkg = os.path.join(REPO, "mxnet_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_no_jax_or_jax_package_imports():
    bad = []
    n_files = 0
    for path in _sources():
        n_files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) \
                    in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += ["%s:%d %s" % (os.path.relpath(path, REPO), node.lineno,
                                  n) for n in names if _forbidden(n)]
    assert n_files > 10
    assert not bad, bad


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxnet_tpu'] = None\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "s = mx.models.get_symbol('resnet-18', num_classes=4,"
        " image_shape=(3, 64, 64))\n"
        "args, outs, aux = s.infer_shape(data=(1, 3, 64, 64))\n"
        "assert outs == [(1, 4)], outs\n"
        "s = mx.models.get_symbol('resnet', num_layers=8, num_classes=4,"
        " image_shape=(3, 8, 8))\n"
        "tr = mx.parallel.SPMDTrainer(s, 'sgd', {'learning_rate': 0.1,"
        " 'momentum': 0.9, 'rescale_grad': 0.5}, ctx=mx.cpu())\n"
        "tr.bind([('data', (2, 3, 8, 8))], [('softmax_label', (2,))])\n"
        "tr.init_params(mx.initializer.Xavier())\n"
        "out = tr.step(np.ones((2, 3, 8, 8), np.float32),"
        " np.zeros(2, np.float32))[0]\n"
        "assert out.shape == (2, 4) and tr.skipped_steps == 0\n"
        "from mxnet_tpu_torch.models import lstm_lm\n"
        "s, _, _ = lstm_lm.lstm_lm_sym(5, 30, 8, 8, 2)\n"
        "tr = mx.parallel.SPMDTrainer(s, 'sgd', {'learning_rate': 0.1,"
        " 'momentum': 0.9, 'rescale_grad': 0.5}, ctx=mx.cpu())\n"
        "tr.bind([('data', (2, 5))], [('softmax_label', (2, 5))])\n"
        "tr.init_params(mx.initializer.Xavier())\n"
        "ids = np.arange(10, dtype=np.float32).reshape(2, 5)\n"
        "out = tr.step(ids, ids)[0]\n"
        "assert out.shape == (10, 30) and tr.skipped_steps == 0\n"
        "import os, torch\n"
        "os.environ['MXTPU_FLASH_BLOCK'] = '8'\n"
        "from mxnet_tpu_torch.models import long_context_lm as lc\n"
        "p = lc.build_params(torch.Generator().manual_seed(0), 16, 8, 2, 1,"
        " 16, max_len=32, ctx=mx.cpu())\n"
        "rs = np.random.RandomState(0)\n"
        "x, y = lc.markov_batch(rs, rs.randint(1, 16, (16, 3)), 2, 20, 16)\n"
        "p, loss = lc.make_step(None, 2, 1, 0.3)(p, x, y)\n"
        "assert loss.ndim == 0 and np.isfinite(float(loss))\n"
        "silu = mx.rtc.elementwise_cuda_kernel('out = in / (1.0f + "
        "expf(-in));', plain=lambda x: x / (1 + torch.exp(-x)))\n"
        "mx.rtc.register_kernel('iso_silu', vjp=lambda x, g: g * torch."
        "sigmoid(x) * (1 + x * (1 - torch.sigmoid(x))))(lambda data: "
        "silu(data))\n"
        "net = mx.sym.iso_silu(mx.sym.FullyConnected(mx.sym.Variable("
        "'data'), num_hidden=8, name='fc1'))\n"
        "net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(net, "
        "num_hidden=3, name='fc2'), name='softmax')\n"
        "X = rs.standard_normal((32, 5)).astype(np.float32)\n"
        "Y = rs.randint(0, 3, 32).astype(np.float32)\n"
        "for kv in ('tpu', 'local'):\n"
        "    m = mx.mod.Module(net, context=mx.cpu())\n"
        "    m.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1, "
        "kvstore=kv, eval_metric=['acc', mx.metric.create("
        "'top_k_accuracy', top_k=2)], batch_end_callback="
        "mx.callback.Speedometer(8, 2))\n"
        "    assert (m._fused is not None) == (kv == 'tpu')\n"
        "    assert m.predict(mx.io.NDArrayIter(X, Y, batch_size=8))"
        ".shape == (32, 3)\n"
        "atk = mx.mod.Module(net, context=mx.cpu())\n"
        "atk.bind(data_shapes=[('data', (8, 5))], label_shapes=["
        "('softmax_label', (8,))], for_training=True, "
        "inputs_need_grad=True)\n"
        "atk.set_params(*m.get_params())\n"
        "x = mx.nd.array(X[:8], ctx=mx.cpu())\n"
        "label = mx.nd.array(Y[:8], ctx=mx.cpu())\n"
        "atk.forward(mx.io.DataBatch([x], [label]), is_train=True)\n"
        "atk.backward()\n"
        "g = atk.get_input_grads()[0]\n"
        "x_adv = mx.nd.clip(x + 0.1 * mx.nd.sign(g), 0, 1)\n"
        "assert float(mx.nd.max(x_adv)) <= 1 and float(mx.nd.min(x_adv))"
        " >= 0\n"
        "assert float(mx.nd.sum(x_adv != mx.nd.clip(x, 0, 1))) > 0\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', "
        "'mxnet_tpu.')) and sys.modules[m] is not None]\n"
        "print('ok', len(args))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok ")


def test_bucketing_stack_runs_with_jax_unimportable():
    """The bucketing slice's modules import and run with JAX made
    unimportable: a BucketSentenceIter -> BucketingModule.fit of a small
    LSTM LM on both stacks (Perplexity, eval data), the other cells, the
    Sequence ops, SequentialModule over a PythonLossModule, FeedForward
    and the executor manager, the new schedules and initializers."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxnet_tpu'] = None\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.module import bucketing_module, "
        "sequential_module, python_module\n"
        "from mxnet_tpu_torch.rnn import io, rnn\n"
        "from mxnet_tpu_torch import executor_manager\n"
        "rs = np.random.RandomState(0)\n"
        "sents = [list(rs.randint(1, 20, rs.randint(2, 9))) for _ in "
        "range(40)]\n"
        "for fused in (0, 1):\n"
        "    it = mx.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8], "
        "invalid_label=0)\n"
        "    stack = mx.rnn.FusedRNNCell(6, num_layers=2, prefix='l_') "
        "if fused else mx.rnn.FusedRNNCell(6, num_layers=2, prefix='l_')"
        ".unfuse()\n"
        "    def gen(T):\n"
        "        e = mx.sym.Embedding(mx.sym.Variable('data'), "
        "input_dim=20, output_dim=5, name='embed')\n"
        "        stack.reset()\n"
        "        o, _ = stack.unroll(T, inputs=e, merge_outputs=True)\n"
        "        o = mx.sym.FullyConnected(mx.sym.Reshape(o, shape=(-1, 6)),"
        " num_hidden=20, name='pred')\n"
        "        lab = mx.sym.Reshape(mx.sym.Variable('softmax_label'), "
        "shape=(-1,))\n"
        "        return mx.sym.SoftmaxOutput(o, lab, name='softmax'), "
        "('data',), ('softmax_label',)\n"
        "    m = mx.mod.BucketingModule(gen, default_bucket_key=8, "
        "context=mx.cpu())\n"
        "    m.fit(it, eval_data=it, eval_metric=mx.metric.Perplexity(0), "
        "initializer=mx.initializer.Orthogonal(), num_epoch=1, "
        "optimizer_params={'learning_rate': 0.1, 'lr_scheduler': "
        "mx.lr_scheduler.CosineScheduler(20, 0.1)})\n"
        "    assert sorted(m._buckets) == [4, 8]\n"
        "bi = mx.rnn.BidirectionalCell(mx.rnn.GRUCell(3, prefix='a_'), "
        "mx.rnn.ZoneoutCell(mx.rnn.RNNCell(3, prefix='b_'), 0.5))\n"
        "o, _ = bi.unroll(4, inputs=mx.sym.Variable('data'), "
        "merge_outputs=True)\n"
        "ex = o.simple_bind(mx.cpu(), data=(2, 4, 5))\n"
        "assert ex.forward()[0].shape == (2, 4, 6)\n"
        "X = rs.standard_normal((16, 5)).astype(np.float32)\n"
        "Y = rs.randint(0, 3, 16).astype(np.float32)\n"
        "net = mx.sym.FullyConnected(mx.sym.Variable('data'), "
        "num_hidden=3, name='fc')\n"
        "seq = mx.mod.SequentialModule().add(mx.mod.Module(net, "
        "label_names=[], context=mx.cpu())).add(mx.mod.PythonLossModule("
        "grad_func=lambda s, l: s.asnumpy() * 0.1), take_labels=True, "
        "auto_wiring=True)\n"
        "seq.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1)\n"
        "ff = mx.model.FeedForward(mx.sym.SoftmaxOutput(net, "
        "name='softmax'), ctx=mx.cpu(), num_epoch=1, numpy_batch_size=8, "
        "initializer=mx.initializer.Xavier())\n"
        "ff.fit(X, Y)\n"
        "assert ff.predict(X).shape == (16, 3)\n"
        "w = mx.nd.zeros((1, 1, 4, 4), ctx=mx.cpu())\n"
        "mx.initializer.Bilinear()('up_weight', w)\n"
        "assert mx.lr_scheduler.PolyScheduler(10)(5) > 0\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', "
        "'mxnet_tpu.')) and sys.modules[m] is not None]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_extension_surface_runs_with_jax_unimportable():
    """The extension slice's modules (``autograd``, ``operator``,
    ``monitor``, ``torch_bridge``) and the mirror mode import and run with
    JAX made unimportable: a gradient through ``contrib.autograd``, a
    CustomOp trained in a Module fit under a Monitor, a TorchModule node,
    ``mx.th``, a mirrored executor step and ``Executor.close``."""
    code = (
        "import sys, os\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxnet_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch import autograd, operator, monitor, "
        "torch_bridge\n"
        "from mxnet_tpu_torch.contrib import autograd as cag\n"
        "with mx.cpu():\n"
        "    g = cag.grad(lambda v: mx.nd.sum(v * v))(mx.nd.ones((3,)))[0]\n"
        "    assert g.asnumpy().tolist() == [2.0, 2.0, 2.0]\n"
        "    class Half(mx.operator.CustomOp):\n"
        "        def forward(self, is_train, req, in_data, out_data, aux):\n"
        "            self.assign(out_data[0], req[0], in_data[0] * 0.5)\n"
        "        def backward(self, req, out_grad, in_data, out_data, "
        "in_grad, aux):\n"
        "            self.assign(in_grad[0], req[0], out_grad[0] * 0.5)\n"
        "    @mx.operator.register('iso_half')\n"
        "    class HalfProp(mx.operator.CustomOpProp):\n"
        "        def create_operator(self, ctx, shapes, dtypes):\n"
        "            return Half()\n"
        "    net = mx.sym.Custom(mx.sym.Variable('data'), op_type='iso_half')\n"
        "    net = mx.torch_bridge.TorchModule(torch.nn.Linear(4, 3), net, "
        "name='tl')\n"
        "    net = mx.sym.SoftmaxOutput(net, name='softmax')\n"
        "    rs = np.random.RandomState(0)\n"
        "    X = rs.randn(16, 4).astype('f')\n"
        "    Y = rs.randint(0, 3, 16).astype('f')\n"
        "    mon = mx.mon.Monitor(1, pattern='.*output')\n"
        "    m = mx.mod.Module(net, context=mx.cpu())\n"
        "    m.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1, "
        "monitor=mon, initializer=mx.initializer.Xavier())\n"
        "    assert mon.step == 2 and operator.HOST_COUNTS['forward'] == 2\n"
        "    assert mx.th.add(mx.nd.ones((2,)), 1).asnumpy().tolist() == "
        "[2.0, 2.0]\n"
        "    os.environ['MXNET_BACKWARD_DO_MIRROR'] = '1'\n"
        "    s = mx.models.get_symbol('resnet', num_layers=8, num_classes=4,"
        " image_shape=(3, 8, 8))\n"
        "    with s.simple_bind(mx.cpu(), data=(2, 3, 8, 8)) as ex:\n"
        "        assert ex._eval.segments\n"
        "        ex.forward(is_train=True)\n"
        "        ex.backward()\n"
        "    assert ex._eval is None\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', "
        "'mxnet_tpu.')) and sys.modules[m] is not None]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "ok"      # after the monitor rows


def test_input_pipeline_runs_with_jax_unimportable(tmp_path):
    """The input-pipeline slice's modules import and run with JAX made
    unimportable: a seeded ``.rec`` built with ``recordio.pack_img``, all
    three ``ImageRecordIter`` routes (native, decode worker processes,
    engine), the image I/O ops, and one ``SPMDTrainer`` step fed through
    ``DevicePrefetchIter``."""
    script = tmp_path / "pipeline.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['mxnet_tpu'] = None\n"
        "sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "def main():\n"
        "    rs = np.random.RandomState(0)\n"
        "    p = %r\n"
        "    w = mx.recordio.MXIndexedRecordIO(p + '.idx', p + '.rec', 'w')\n"
        "    for i in range(8):\n"
        "        img = (rs.rand(20, 24, 3) * 255).astype(np.uint8)\n"
        "        w.write_idx(i, mx.recordio.pack_img((0, float(i %% 4), i, "
        "0), img))\n"
        "    w.close()\n"
        "    with mx.cpu():\n"
        "        routes = []\n"
        "        for kw in ({}, {'pad': 0}, {'aug_list': "
        "[mx.image.CenterCropAug((16, 16)), mx.image.CastAug()]}):\n"
        "            it = mx.io.ImageRecordIter(p + '.rec', (3, 16, 16), 4, "
        "preprocess_threads=2, seed=1, **kw)\n"
        "            bs = [b.data[0].shape for b in it]\n"
        "            assert bs == [(4, 3, 16, 16)] * 2, bs\n"
        "            routes.append(it.route)\n"
        "            it.close()\n"
        "        assert routes == ['native', 'process', 'engine'], routes\n"
        "        x = mx.nd.imresize(mx.nd.ones((5, 6, 3)), w=3, h=2)\n"
        "        assert x.shape == (2, 3, 3)\n"
        "        net = mx.models.get_symbol('resnet', num_layers=8, "
        "num_classes=4, image_shape=(3, 16, 16))\n"
        "        tr = mx.parallel.SPMDTrainer(net, 'sgd', {'learning_rate': "
        "0.1}, mesh=None, ctx=mx.cpu())\n"
        "        tr.bind([('data', (4, 3, 16, 16))], [('softmax_label', "
        "(4,))])\n"
        "        tr.init_params(mx.initializer.Xavier())\n"
        "        it = mx.DevicePrefetchIter(mx.io.ImageRecordIter(p + '.rec', "
        "(3, 16, 16), 4), stage=tr)\n"
        "        b = it.next()\n"
        "        assert isinstance(b, mx.io.StagedBatch)\n"
        "        assert np.isfinite(tr.step(b)[0].numpy()).all()\n"
        "        it.close()\n"
        "    assert not [m for m in sys.modules if m.startswith(('jax', "
        "'mxnet_tpu.')) and sys.modules[m] is not None]\n"
        "    print('ok')\n"
        "if __name__ == '__main__':\n"
        "    main()\n" % (REPO, str(tmp_path / "p")))
    res = subprocess.run([sys.executable, str(script)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "ok"


def _poisoned_path(tmp_path):
    """A PYTHONPATH entry under which ``torch``, ``jax`` and ``mxnet_tpu``
    raise at import."""
    poison = tmp_path / "poison"
    for name in ("torch", "jax", "mxnet_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            "raise ImportError('%s must not be imported here')\n" % name)
    return str(poison) + os.pathsep + os.environ.get("PYTHONPATH", "")


def test_data_service_processes_run_with_torch_and_jax_unimportable(
        tmp_path):
    """The decode worker, the coordinator and the server entry point
    (``data_service/_worker_main.py``, ``service.py``, ``server_main.py``)
    never import torch or JAX: with both unimportable, a local
    ``DataService`` under the stub package streams a real epoch from two
    workers, and a server started by path streams one (its workers
    inherit the poisoned path) to this process's consumer."""
    from mxnet_tpu_torch import recordio
    import numpy as np
    prefix = str(tmp_path / "d")
    rs = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(12):
        w.write_idx(i, recordio.pack_img(
            (0, float(i), i, 0), (rs.rand(40, 44, 3) * 255).astype(
                np.uint8)))
    w.close()
    env = dict(os.environ, PYTHONPATH=_poisoned_path(tmp_path))
    ds_dir = os.path.join(REPO, "mxnet_tpu_torch", "data_service")
    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import _worker_main\n"
        "_worker_main.bootstrap()\n"
        "from mxnet_tpu_torch.data_service.service import DataService\n"
        "svc = DataService(%r, %r, (3, 32, 32), 4, num_workers=2, "
        "shuffle=True, aug={'rand_crop': True})\n"
        "n = 0\n"
        "while True:\n"
        "    try:\n"
        "        d, lab, pad, rel = svc.next_batch()\n"
        "    except StopIteration:\n"
        "        break\n"
        "    assert d.shape == (4, 3, 32, 32) and d.std() > 0\n"
        "    n += 1\n"
        "st = svc.stats()\n"
        "svc.close()\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'mxnet_tpu')]\n"
        "assert st['batches_produced'] == 3 and all(w['respawns'] == 0 "
        "for w in st['workers'].values()), st\n"
        "print('ok', n)\n" % (ds_dir, prefix + ".rec", prefix + ".idx"))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["ok", "3"]
    pf = str(tmp_path / "port")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ds_dir, "server_main.py"), "--port",
         "0", "--port-file", pf], cwd=str(tmp_path),
        stderr=subprocess.DEVNULL, env=env)
    try:
        import time
        deadline = time.monotonic() + 60
        while not os.path.exists(pf):
            assert proc.poll() is None, "the server died at startup"
            assert time.monotonic() < deadline
            time.sleep(0.05)
        with open(pf) as f:
            addr = f.read().strip()
        from mxnet_tpu_torch.data_service import DataServiceIter
        from mxnet_tpu_torch.data_service.net import NetDataService
        it = DataServiceIter(NetDataService(
            addr, prefix + ".rec", prefix + ".idx", (3, 32, 32), 4,
            workers_per_server=2, retries=2))
        shapes = [tuple(b.data[0].shape) for b in it]
        it.close()
        assert shapes == [(4, 3, 32, 32)] * 3
        assert proc.poll() is None
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_new_modules_are_covered():
    """The extension, input-pipeline and data-service slices' modules are
    among the sources the import check walks."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("autograd", "operator", "monitor", "torch_bridge",
                "contrib/autograd", "recordio", "image", "image_det",
                "engine", "dataflow", "resilience", "native/__init__",
                "data_service/__init__", "data_service/common",
                "data_service/ring", "data_service/_worker_main",
                "data_service/service", "data_service/iter",
                "data_service/net", "data_service/server_main",
                "kernels/augment", "ops/image_io"):
        assert "mxnet_tpu_torch/%s.py" % mod in names, mod


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
