"""The PyTorch port's Symbol against the JAX package's: the same builders
give identical graph JSON, each package loads the other's JSON, and shape
inference and attribute validation agree."""
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

MODELS = [("resnet-50", (3, 224, 224)), ("resnet-18", (3, 224, 224)),
          ("resnet-18", (3, 64, 64))]


def _build(pkg, name, image_shape):
    # a fresh NameManager per build: auto-names (pooling0, flatten0) count
    # per process, and other tests in this worker may have built symbols
    with pkg.name.NameManager():
        return pkg.models.get_symbol(name, num_classes=10,
                                     image_shape=image_shape)


def _fresh(build, pkg):
    with pkg.name.NameManager():
        return build(pkg)


@pytest.mark.parametrize("name,image_shape", MODELS)
def test_identical_json_and_cross_load(name, image_shape):
    sj, st = _build(mxj, name, image_shape), _build(mxt, name, image_shape)
    assert st.tojson() == sj.tojson()
    # each package loads the other's JSON back to the same text
    assert mxt.sym.load_json(sj.tojson()).tojson() == sj.tojson()
    assert mxj.sym.load_json(st.tojson()).tojson() == st.tojson()
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    assert st.list_outputs() == sj.list_outputs()
    assert st.get_internals().list_outputs() == \
        sj.get_internals().list_outputs()


@pytest.mark.parametrize("name,image_shape", MODELS)
def test_infer_shape_agrees(name, image_shape):
    sj, st = _build(mxj, name, image_shape), _build(mxt, name, image_shape)
    data = (2,) + image_shape
    assert st.infer_shape(data=data) == sj.infer_shape(data=data)
    internals_j, internals_t = sj.get_internals(), st.get_internals()
    assert internals_t.infer_shape(data=data)[1] == \
        internals_j.infer_shape(data=data)[1]


def test_infer_shape_without_op_shape_function():
    """Activation/elemwise_add/Flatten/identity have no infer_shape: the
    port runs them on meta tensors where JAX used eval_shape."""
    def build(pkg):
        data = pkg.sym.Variable("data")
        a = pkg.sym.Activation(data, act_type="tanh", name="act")
        b = pkg.sym.identity(data, name="id")
        s = pkg.sym.Flatten(a + b, name="flat")
        return pkg.sym.FullyConnected(s, num_hidden=3, name="fc")
    shapes = {"data": (2, 3, 5, 7)}
    st, sj = _fresh(build, mxt), _fresh(build, mxj)
    assert st.tojson() == sj.tojson()
    assert st.infer_shape(**shapes) == sj.infer_shape(**shapes)
    assert st.infer_shape_partial()[0] == sj.infer_shape_partial()[0]


def test_compose_and_variable_shape_attr():
    def build(pkg):
        data = pkg.sym.Variable("data", shape=(4, 6))
        net = pkg.sym.FullyConnected(pkg.sym.Variable("x"), num_hidden=5,
                                     name="fc")
        return net(x=data)
    st, sj = _fresh(build, mxt), _fresh(build, mxj)
    assert st.tojson() == sj.tojson()
    assert st.infer_shape() == sj.infer_shape()


@pytest.mark.parametrize("pkg", [mxj, mxt], ids=["jax", "torch"])
def test_bad_attribute_raises(pkg):
    data = pkg.sym.Variable("data")
    with pytest.raises(pkg.MXNetError, match="kernal"):
        pkg.sym.Convolution(data, kernal=(3, 3), num_filter=2)
    with pytest.raises(pkg.MXNetError):
        pkg.sym.Pooling(data, kernel=(2, 2), pool_typ="max")
    bad = _build(mxj, "resnet-18", (3, 64, 64)).tojson().replace(
        '"op": "Pooling"', '"op": "NoSuchOp"')
    with pytest.raises(pkg.MXNetError, match="NoSuchOp"):
        pkg.sym.load_json(bad)


def test_save_and_load_file(tmp_path):
    st = _build(mxt, "resnet-18", (3, 64, 64))
    st.save(str(tmp_path / "r18-symbol.json"))
    sj = mxj.sym.load(str(tmp_path / "r18-symbol.json"))
    assert sj.tojson() == st.tojson()
    assert mxt.sym.load(str(tmp_path / "r18-symbol.json")).tojson() == \
        st.tojson()
