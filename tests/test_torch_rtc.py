"""The port's rtc escape hatch (``mxnet_tpu_torch/rtc.py``) against the
JAX package's (``mxnet_tpu/rtc.py``).

The cases of ``tests/test_rtc.py`` run on the port with ``cpu()``: the
elementwise CUDA kernel takes its plain version there.  Parity: the same
function written as a Pallas body (the JAX package, interpret mode on the
CPU) and as a CUDA body with its plain version (the port) give the same
forward and gradient through ``simple_bind`` on the same seeded inputs,
rtol 1e-6 / atol 1e-7 in float32 (the two frameworks' ``exp`` differ by
an ulp).  The kernel itself runs on the card only: the ``cuda``-marked
test holds it against its plain version there."""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kernels as tkernels
from mxnet_tpu_torch import rtc as trtc

RTOL, ATOL = 1e-6, 1e-7

SILU = "out = in / (1.0f + expf(-in));"
DSILU = ("float s = 1.0f / (1.0f + expf(-in)); "
         "out = s * (1.0f + in * (1.0f - s));")
AFFINE = "out = 2.0f * in + 1.0f;"


def _silu_plain(x):
    return x / (1.0 + torch.exp(-x))


def _dsilu_plain(x):
    s = 1.0 / (1.0 + torch.exp(-x))
    return s * (1.0 + x * (1.0 - s))


def _affine_plain(x):
    return 2.0 * x + 1.0


def _jax_silu_body(in_ref, out_ref):
    x = in_ref[...]
    out_ref[...] = x / (1.0 + jnp.exp(-x))


def _jax_dsilu_body(in_ref, out_ref):
    x = in_ref[...]
    s = 1.0 / (1.0 + jnp.exp(-x))
    out_ref[...] = s * (1.0 + x * (1.0 - s))


def _jax_affine_body(in_ref, out_ref):
    out_ref[...] = in_ref[...] * 2.0 + 1.0


#: name -> (port body, port plain, port derivative, JAX body, JAX
#: derivative body); the affine map's derivative is the constant 2
FUNCTIONS = {
    "silu": (SILU, _silu_plain, (DSILU, _dsilu_plain), _jax_silu_body,
             _jax_dsilu_body),
    "affine": (AFFINE, _affine_plain, None, _jax_affine_body, None),
}


def _register_pair(name):
    """Register the function as ``trtc_<name>`` in both packages (once
    per process) with its hand-written vjp."""
    op = "trtc_" + name
    body, plain, deriv, jbody, jderiv = FUNCTIONS[name]
    if op not in tmx.ops.registry.OP_REGISTRY:
        fwd = tmx.rtc.elementwise_cuda_kernel(body, plain=plain)
        if deriv is None:
            def vjp(x, g):
                return 2.0 * g
        else:
            dk = tmx.rtc.elementwise_cuda_kernel(*deriv)

            def vjp(x, g):
                return dk(x) * g
        tmx.rtc.register_kernel(op, vjp=vjp)(lambda data: fwd(data))
    if op not in jmx.ops.registry.OP_REGISTRY:
        jfwd = jmx.rtc.elementwise_pallas_kernel(jbody)
        if jderiv is None:
            def jvjp(x, g):
                return (2.0 * g,)
        else:
            jd = jmx.rtc.elementwise_pallas_kernel(jderiv)

            def jvjp(x, g):
                return (jd(x) * g,)
        jmx.rtc.register_kernel(op, vjp=jvjp)(lambda data: jfwd(data))
    return op


# ---------------------------------------------------------------------------
# the cases of tests/test_rtc.py, on the port
# ---------------------------------------------------------------------------

def test_register_elementwise_kernel_nd_and_sym():
    fn = tmx.rtc.elementwise_cuda_kernel(AFFINE, plain=_affine_plain)

    @tmx.rtc.register_kernel("trtc_scale_shift",
                             vjp=lambda x, g: (2.0 * g,))
    def trtc_scale_shift(data):
        return fn(data)

    x = np.random.RandomState(0).rand(8, 16).astype("f")
    y = tmx.nd.trtc_scale_shift(tmx.nd.array(x, ctx=tmx.cpu()))
    np.testing.assert_allclose(y.asnumpy(), x * 2 + 1, rtol=1e-6)
    data = tmx.sym.Variable("data")
    net = tmx.sym.sum(tmx.sym.trtc_scale_shift(data))
    ex = net.simple_bind(tmx.cpu(), data=(8, 16))
    ex.arg_dict["data"][:] = x
    out = ex.forward(is_train=True)[0].asnumpy()
    np.testing.assert_allclose(out, (x * 2 + 1).sum(), rtol=1e-5)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                               np.full_like(x, 2.0), rtol=1e-6)


def test_register_kernel_custom_vjp():
    @tmx.rtc.register_kernel(
        "trtc_cube", vjp=lambda x, g: (3.0 * x * x * g,))
    def trtc_cube(data):
        return data ** 3

    x = np.asarray([[1.0, 2.0], [3.0, 0.5]], "f")
    net = tmx.sym.sum(tmx.sym.trtc_cube(tmx.sym.Variable("data")))
    ex = net.simple_bind(tmx.cpu(), data=(2, 2))
    ex.arg_dict["data"][:] = x
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), 3 * x * x,
                               rtol=1e-5)


def test_register_kernel_duplicate_rejected():
    with pytest.raises(tmx.MXNetError, match="already registered"):
        tmx.rtc.register_kernel("Activation")(lambda data: data)


def test_mxrtc_parity_class():
    def kernel(x, y):
        return x * y + 1.0

    a = tmx.nd.array(np.full((4, 4), 3.0, "f"), ctx=tmx.cpu())
    b = tmx.nd.array(np.full((4, 4), 2.0, "f"), ctx=tmx.cpu())
    out = tmx.nd.zeros((4, 4), ctx=tmx.cpu())
    rtc = tmx.rtc.MXRtc("mul1", [("a", a), ("b", b)], [("c", out)], kernel)
    rtc.push([a, b], [out], (1, 1, 1), (4, 4, 1))
    np.testing.assert_allclose(out.asnumpy(), np.full((4, 4), 7.0, "f"))


def test_mxrtc_passes_grid_dims_and_casts():
    """``push`` hands grid/block dims to a kernel that takes them and
    casts the result into the output's dtype; an ElementwiseKernel (no
    such parameters) is called with the arrays alone."""
    seen = {}

    def kernel(x, grid_dims=None, block_dims=None):
        seen["dims"] = (grid_dims, block_dims)
        return x * 2.0

    a = tmx.nd.array(np.arange(6, dtype="f").reshape(2, 3), ctx=tmx.cpu())
    out = tmx.nd.zeros((2, 3), ctx=tmx.cpu(), dtype="float64")
    tmx.rtc.MXRtc("k", [("a", a)], [("o", out)], kernel).push(
        [a], [out], (2, 1, 1), (3, 1, 1))
    assert seen["dims"] == ((2, 1, 1), (3, 1, 1))
    assert out.dtype is np.float64 and out._data.dtype == torch.float64
    np.testing.assert_array_equal(out.asnumpy(), a.asnumpy() * 2.0)
    ek = tmx.rtc.elementwise_cuda_kernel(AFFINE, plain=_affine_plain)
    tmx.rtc.MXRtc("e", [("a", a)], [("o", out)], ek).push([a], [out])
    np.testing.assert_array_equal(out.asnumpy(), a.asnumpy() * 2.0 + 1.0)


def test_mxrtc_rejects_cuda_source():
    with pytest.raises(tmx.MXNetError, match="elementwise_cuda_kernel"):
        tmx.rtc.MXRtc("k", [], [], "__global__ void k() {}")


def test_register_kernel_vjp_with_params():
    """A vjp kernel with op parameters: the attributes reach both the
    forward and the vjp through the autograd.Function."""
    @tmx.rtc.register_kernel("trtc_scale_p",
                             vjp=lambda x, g, scalar=2.0: (scalar * g,))
    def trtc_scale_p(data, scalar=2.0):
        return data * scalar

    x = np.random.RandomState(1).rand(3, 4).astype("f")
    y = tmx.nd.trtc_scale_p(tmx.nd.array(x, ctx=tmx.cpu()), scalar=3.0)
    np.testing.assert_allclose(y.asnumpy(), x * 3.0, rtol=1e-6)
    net = tmx.sym.sum(tmx.sym.trtc_scale_p(tmx.sym.Variable("data"),
                                           scalar=3.0))
    ex = net.simple_bind(tmx.cpu(), data=(3, 4))
    ex.arg_dict["data"][:] = x
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                               np.full_like(x, 3.0), rtol=1e-6)
    # f's signature is kept: an unknown attribute is refused
    with pytest.raises(tmx.MXNetError, match="unknown parameter"):
        tmx.sym.trtc_scale_p(tmx.sym.Variable("data"), scaler=3.0)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_forward_and_gradient_match_jax(name):
    """Forward and gradient through simple_bind: the JAX package's Pallas
    body (interpret mode) against the port's CUDA body's plain version."""
    op = _register_pair(name)
    rs = np.random.RandomState(7)
    x = (rs.standard_normal((6, 32)) * 3).astype(np.float32)
    g = rs.standard_normal((6, 32)).astype(np.float32)
    results = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        net = getattr(mx.sym, op)(mx.sym.Variable("data"))
        ex = net.simple_bind(ctx, data=x.shape)
        ex.arg_dict["data"][:] = x
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=[mx.nd.array(g, ctx=ctx)])
        results.append((out, ex.grad_dict["data"].asnumpy()))
    (jout, jgrad), (tout, tgrad) = results
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=ATOL)
    # and the imperative call
    got = getattr(tmx.nd, op)(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    ref = getattr(jmx.nd, op)(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the template, the build route, the CPU contract
# ---------------------------------------------------------------------------

def test_render_pastes_body_into_template():
    src = trtc.render(SILU)
    assert SILU in src and "/*@MXT_RTC_BODY@*/" not in src
    for entry in ("mxt_rtc_elementwise_f32", "mxt_rtc_elementwise_bf16",
                  "mxt_rtc_elementwise_f16", "mxt_rtc_elementwise_f64"):
        assert 'extern "C" int %s(' % entry in src
    a = tmx.rtc.elementwise_cuda_kernel(SILU, plain=_silu_plain)
    b = tmx.rtc.elementwise_cuda_kernel(DSILU, plain=_dsilu_plain)
    same = tmx.rtc.elementwise_cuda_kernel(SILU)
    assert a.name != b.name and a.name == same.name
    pa = tkernels.library_path(a.name, a.source)
    pb = tkernels.library_path(b.name, b.source)
    assert pa != pb and pa == tkernels.library_path(same.name, same.source)
    assert os.sep + "rtc" + os.sep in pa
    # nothing was built: building waits for the first CUDA call
    assert a.build_seconds is None and a._lib is None
    for bad in ("", "   ", None):
        with pytest.raises(tmx.MXNetError):
            tmx.rtc.elementwise_cuda_kernel(bad)


def test_build_reports_what_it_compiled_and_reuses_the_library(
        tmp_path, monkeypatch):
    """``build`` returns the seconds of the sources it compiled; a second
    build of the same body finds the library and runs no compiler (a
    stand-in compiler here, which writes its ``-o`` file and logs each
    call)."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != -o ]; do '
                    'shift; done\ntouch "$2"\n' % calls)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tkernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(tkernels, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(tkernels, "_GENERATED", str(tmp_path / "build"
                                                    / "rtc"))
    k = tmx.rtc.elementwise_cuda_kernel(AFFINE, plain=_affine_plain)
    built = tkernels.build([k.name], sources={k.name: k.source})
    assert list(built) == [k.name] and built[k.name] >= 0.0
    assert os.path.exists(tkernels.library_path(k.name, k.source))
    again = tmx.rtc.elementwise_cuda_kernel(AFFINE, plain=_affine_plain)
    assert tkernels.build([again.name], sources={again.name: again.source}) \
        == {}
    assert calls.read_text().count("x") == 1


def test_cpu_call_takes_plain_and_needs_it():
    k = tmx.rtc.elementwise_cuda_kernel(SILU, plain=_silu_plain)
    x = torch.randn(3, 5, 7, 3, generator=torch.Generator().manual_seed(0))
    before = trtc.LAUNCHES
    y = k(x.transpose(1, 2))
    assert trtc.LAUNCHES == before   # the plain version launches nothing
    assert y.shape == (3, 7, 5, 3) and y.dtype == x.dtype
    torch.testing.assert_close(y, _silu_plain(x.transpose(1, 2)))
    empty = k(torch.empty(0, 4))
    assert empty.shape == (0, 4)
    with pytest.raises(tmx.MXNetError, match="plain="):
        tmx.rtc.elementwise_cuda_kernel(SILU)(x)
    # shape inference (meta tensors) needs neither the card nor plain
    meta = tmx.rtc.elementwise_cuda_kernel(SILU)(
        torch.empty(2, 3, device="meta", dtype=torch.bfloat16))
    assert meta.shape == (2, 3) and meta.dtype == torch.bfloat16


def test_kernel_without_vjp_refuses_the_backward():
    k = tmx.rtc.elementwise_cuda_kernel(SILU, plain=_silu_plain)
    x = torch.randn(4, requires_grad=True)
    y = k(x)
    assert y.grad_fn is not None
    with pytest.raises(tmx.MXNetError, match="vjp"):
        y.sum().backward()
    # with grad off the output is a plain tensor
    with torch.no_grad():
        assert k(x).grad_fn is None


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    """A body that does not compile raises MXNetError carrying nvcc's
    message (a stand-in compiler here, which prints an error and
    fails)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"error: expected a ';'\" >&2\n"
                    "exit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tkernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(tkernels, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(tkernels, "_GENERATED", str(tmp_path / "build"
                                                    / "rtc"))
    k = tmx.rtc.elementwise_cuda_kernel("out = in +;", plain=_silu_plain)
    with pytest.raises(tmx.MXNetError, match="expected a ';'"):
        tkernels.build([k.name], sources={k.name: k.source})
    # the rendered source was written for the compiler, and no library
    assert list((tmp_path / "build" / "rtc").glob("*.cu"))
    assert not list((tmp_path / "build" / "rtc").glob("*.so"))


def test_on_gpu_is_cuda_availability():
    assert tmx.rtc.on_gpu() == torch.cuda.is_available()


@pytest.mark.parametrize("address,n,itemsize,want", [
    (0, 0, 4, (0, 0, 0)),
    (0, 3, 4, (0, 0, 3)),             # shorter than one vector: all tail
    (0, 4, 4, (0, 1, 0)),
    (0, 10, 4, (0, 2, 2)),
    (4, 10, 4, (3, 1, 3)),            # a float32 x[1:]: 4 bytes off
    (4, 2, 4, (2, 0, 0)),             # all head
    (12, 25690112, 4, (1, 6422527, 3)),
    (0, 25690112, 4, (0, 6422528, 0)),  # (32, 256, 56, 56) float32
    (2, 17, 2, (7, 1, 2)),            # bfloat16/float16, 8 a vector
    (14, 9, 2, (1, 1, 0)),
    (8, 5, 8, (1, 2, 0)),             # float64, 2 a vector
    (16 * 7 + 4, 1, 4, (1, 0, 0))])
def test_vector_split(address, n, itemsize, want):
    """How the kernel covers n elements starting at a byte address: a
    scalar head up to the first 16-byte boundary, whole 16-byte vectors,
    a scalar tail of less than one vector; every element exactly once."""
    head, vectors, tail = trtc.vector_split(address, n, itemsize)
    assert (head, vectors, tail) == want
    per = 16 // itemsize
    assert head + vectors * per + tail == n
    assert 0 <= head < per and 0 <= tail < per
    if vectors:
        assert (address + head * itemsize) % 16 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_output_starts_at_the_inputs_offset(dtype, offset):
    """The output is allocated at the input's offset from a 16-byte
    boundary (a view into a slightly longer buffer when it is not 0), so
    one split serves both; it is contiguous and of the input's shape."""
    dt = getattr(torch, dtype)
    x = torch.zeros(40 + offset, dtype=dt)[offset:].view(5, 8)
    y = trtc._output_like(x)
    assert y.shape == x.shape and y.dtype == dt and y.is_contiguous()
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    split = trtc.vector_split(x.data_ptr(), x.numel(), x.element_size())
    assert split == trtc.vector_split(y.data_ptr(), y.numel(),
                                      y.element_size())


def test_render_keeps_one_body_for_every_element_path():
    """The rendered source holds the body once, in the one per-element
    function that the vector body, the head and the tail all call."""
    src = trtc.render(AFFINE)
    assert src.count(AFFINE) == 1
    assert src.count("apply(in[") == 2 and src.count("apply(r[u].v[e])") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_cuda_kernel_matches_plain(dtype):
    """On a CUDA card: the kernel against its plain version (float32 and
    float64 within 2e-6 of the output's range, bfloat16/float16 within one
    ulp of the working type), a second kernel of the same body reusing
    the library, no launch for 0 elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    k = tmx.rtc.elementwise_cuda_kernel(SILU, plain=_silu_plain)
    x = (torch.randn(32, 2048, device="cuda") * 4).to(dt)
    before = trtc.LAUNCHES
    y = k(x)
    ref = _silu_plain(x.to(torch.float64 if dt == torch.float64
                           else torch.float32)).to(dt)
    torch.cuda.synchronize()
    assert trtc.LAUNCHES == before + 1
    err = (y.double() - ref.double()).abs()
    if dt in (torch.float32, torch.float64):
        assert err.max().item() <= 2e-6 * ref.double().abs().max().item()
    else:
        mbits = 7 if dt == torch.bfloat16 else 10
        exp = torch.frexp(ref.float()).exponent.double()
        ulp = torch.pow(2.0, exp - 1 - mbits)
        assert bool((err <= ulp).all())
    again = tmx.rtc.elementwise_cuda_kernel(SILU)
    assert again.build() == 0.0 and again._lib is k._lib
    assert k(torch.empty(0, 3, device="cuda", dtype=dt)).shape == (0, 3)
    assert trtc.LAUNCHES == before + 1
    with pytest.raises(tmx.MXNetError, match="dtype"):
        k(torch.ones(4, device="cuda", dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("offset,n", [(1, 4099), (3, 4101), (0, 7),
                                      (1, 2)])
def test_cuda_kernel_misaligned_input(dtype, offset, n):
    """On a CUDA card: an input that starts off a 16-byte boundary (a
    slice of a flat tensor), with a scalar head and tail: float32 silu
    bit-equal to the plain version, bfloat16/float16 within one ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    k = tmx.rtc.elementwise_cuda_kernel(SILU, plain=_silu_plain)
    flat = (torch.randn(n + offset, device="cuda") * 4).to(dt)
    x = flat[offset:]
    y = k(x)
    ref = _silu_plain(x.float()).to(dt)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.data_ptr() % 16 == x.data_ptr() % 16
    if dt == torch.float32:
        assert torch.equal(y, ref)
    else:
        err = (y.double() - ref.double()).abs()
        mbits = 7 if dt == torch.bfloat16 else 10
        exp = torch.frexp(ref.float()).exponent.double()
        assert bool((err <= torch.pow(2.0, exp - 1 - mbits)).all())
