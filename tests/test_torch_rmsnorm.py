"""``ops.rmsnorm``: the fused RMSNorm behind ``models.t5.RMSNorm``.

On the CPU: the dispatch rule (a pure function of what it reads of x and
the weight, their ``Layout``: device type, dtypes, d, strides, the
weight's shape and device, alignment; the CPU and the meta device take
the plain composition, every CUDA call the kernel, and a CUDA input the
kernel does not take raises), the layout the wrapper reads, the
backward the kernel runs under autograd against the composition's
gradient, and ``RMSNorm``'s CPU output bitwise the composition it always
computed.  On the card (``cuda``, skips without one): the kernel against
the plain composition at the served shapes and every pair of x and
weight dtypes (one bf16 ulp for a bf16 output, 2e-6 relative for a
float32 one), two launches bitwise equal, a CUDA graph's replay bitwise
the eager call, ``ValueError`` on what it does not take, gradients
through the kernel against the composition's, and the module's routes
on the card.  No JAX in this file."""

import pytest
import torch

from mevi_tpu_torch.models.t5 import RMSNorm
from mevi_tpu_torch.ops import rmsnorm as R
from mevi_tpu_torch.scripts import profile_rmsnorm

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
DTYPE_PAIRS = [(BF16, BF16), (BF16, F32), (F32, BF16), (F32, F32)]


def _composition(x, w, eps):
    """``RMSNorm.forward`` as it was written before the kernel."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (w.float() * y).to(x.dtype)


# ---------------------------------------------------------------------------
# the dispatch rule
# ---------------------------------------------------------------------------

# a bf16 (16,384, 768) batch and its weight, as the kernel takes them
CUDA_OK = R.Layout("cuda", BF16, BF16, 768, 768, 1, (768,), (1,), True,
                   0x7F0000000000, 0x7F0000100000)


def _lay(**kw):
    return CUDA_OK._replace(**kw)


@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS + [(F16, F16), (F32, F16)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_rule_sends_other_devices_to_plain(device, xd, wd):
    # whatever the shape: the plain composition takes any input
    assert R.use_kernel(_lay(device_type=device, x_dtype=xd,
                             w_dtype=wd)) is False
    assert R.use_kernel(_lay(device_type=device, x_dtype=xd, w_dtype=wd,
                             d=100, row_stride=None, inner_stride=2,
                             w_shape=(100, 2), w_stride=(2, 1),
                             same_device=False, x_addr=2, w_addr=6)) is False


@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("d,row_stride", [
    (768, 768), (2048, 2048), (512, 576), (512, 512), (8, 8), (1000, 1000),
    (8192, 8192), (768, 1536)])
def test_rule_sends_cuda_to_the_kernel(d, row_stride, xd, wd):
    assert R.use_kernel(_lay(x_dtype=xd, w_dtype=wd, d=d,
                             row_stride=row_stride, w_shape=(d,))) is True


@pytest.mark.parametrize("xd,wd,what", [
    (F16, BF16, "x dtype"), (BF16, F16, "weight dtype"),
    (torch.float64, F32, "x dtype"), (F32, torch.float64, "weight dtype"),
    (F16, F16, "x dtype")])
def test_rule_refuses_other_dtypes_on_cuda(xd, wd, what):
    with pytest.raises(ValueError, match=what):
        R.use_kernel(_lay(x_dtype=xd, w_dtype=wd))


@pytest.mark.parametrize("d", [0, 4, 100, 770, 8200])
def test_rule_refuses_widths_on_cuda(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        R.use_kernel(_lay(d=d, row_stride=d, w_shape=(d,)))


@pytest.mark.parametrize("inner", [0, 2, 768])
def test_rule_refuses_an_inner_stride_on_cuda(inner):
    with pytest.raises(ValueError, match="contiguous"):
        R.use_kernel(_lay(row_stride=1536, inner_stride=inner))


@pytest.mark.parametrize("xd,row_stride", [
    (BF16, None), (BF16, 760), (BF16, 0), (BF16, 772), (F32, 770),
    (F32, 766)])
def test_rule_refuses_rows_the_kernel_cannot_step(xd, row_stride):
    # 772 bf16 = 1,544 bytes and 770 f32 = 3,080 bytes: not 16-byte steps
    with pytest.raises(ValueError, match="row_stride"):
        R.use_kernel(_lay(x_dtype=xd, row_stride=row_stride))


@pytest.mark.parametrize("w_shape,w_stride", [
    ((768, 1), (1, 1)), ((1, 768), (768, 1)), ((384,), (1,)),
    ((768,), (2,)), ((), ())])
def test_rule_refuses_a_weight_that_is_not_one_vector(w_shape, w_stride):
    with pytest.raises(ValueError, match="weight must be contiguous"):
        R.use_kernel(_lay(w_shape=w_shape, w_stride=w_stride))


def test_rule_refuses_a_weight_on_another_device():
    with pytest.raises(ValueError, match="not on x's device"):
        R.use_kernel(_lay(same_device=False))


@pytest.mark.parametrize("x_off,w_off", [(2, 0), (8, 0), (0, 4), (0, 12)])
def test_rule_refuses_unaligned_pointers(x_off, w_off):
    with pytest.raises(ValueError, match="16-byte aligned"):
        R.use_kernel(_lay(x_addr=CUDA_OK.x_addr + x_off,
                          w_addr=CUDA_OK.w_addr + w_off))


def test_row_view_of_the_served_layouts():
    w = torch.zeros(512)
    x = torch.zeros(4, 8, 576)
    lay = R.layout(x[..., :512], w)                   # kv_a's slice
    assert (lay.device_type, lay.d, lay.row_stride, lay.inner_stride) == (
        "cpu", 512, 576, 1)
    assert lay.x_addr == x.data_ptr() and lay.w_addr == w.data_ptr()
    assert (lay.w_shape, lay.w_stride, lay.same_device) == ((512,), (1,),
                                                            True)
    assert R.layout(torch.zeros(3, 5, 768), w).row_stride == 768
    assert R.layout(torch.zeros(2, 768)[:1], w).row_stride == 768  # 1 row
    # (b, l, d) from a time-major (l, b, d): no single row stride
    assert R.layout(torch.zeros(5, 3, 768).transpose(0, 1),
                    w).row_stride is None
    # a view one element in: the kernel would read misaligned rows
    assert R.layout(torch.zeros(2, 769)[:, 1:], w).x_addr % 16 == 4


# ---------------------------------------------------------------------------
# the CPU path: bitwise the composition, no launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS + [(F16, F32), (F16, F16)])
@pytest.mark.parametrize("shape,slice_to", [
    ((3, 768), None), ((2, 5, 64), None), ((4, 7, 72), 64), ((6,), None),
    ((2, 3, 12), None)])
def test_cpu_output_is_the_composition_bitwise(shape, slice_to, xd, wd):
    g = torch.Generator().manual_seed(sum(shape))
    x = (3 * torch.randn(shape, generator=g)).to(xd)
    if slice_to is not None:
        x = x[..., :slice_to]
    norm = RMSNorm(x.shape[-1], eps=1e-6, dtype=wd)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(x.shape[-1], generator=g))
    before = R.launch_count()
    got = norm(x)
    want = _composition(x, norm.weight, 1e-6)
    assert got.dtype == xd and got.shape == x.shape
    assert torch.equal(got, want)
    assert R.launch_count() == before


def test_cpu_autograd_flows_through_the_plain_path():
    norm = RMSNorm(16)
    x = torch.randn(3, 16, requires_grad=True)
    norm(x).square().sum().backward()
    assert x.grad is not None and norm.weight.grad is not None
    assert norm.weight.grad.shape == (16,)


@pytest.mark.parametrize("need_x,need_w", [(True, True), (True, False),
                                            (False, True)])
@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("shape,slice_to", [
    ((3, 64), None), ((2, 5, 48), None), ((4, 7, 72), 64)])
def test_backward_is_the_compositions_gradient(shape, slice_to, xd, wd,
                                               need_x, need_w):
    g = torch.Generator().manual_seed(7 + sum(shape))
    x = (3 * torch.randn(shape, generator=g)).to(xd)
    if slice_to is not None:
        x = x[..., :slice_to]
    d = x.shape[-1]
    w = (1 + 0.1 * torch.randn(d, generator=g)).to(wd)
    go = torch.randn(x.shape, generator=g).to(xd)
    xa = x.detach().requires_grad_(need_x)
    wa = w.detach().requires_grad_(need_w)
    _composition(xa, wa, 1e-6).backward(go)
    dx, dw = R.rmsnorm_backward(go, x, w, 1e-6, need_x, need_w)
    for got, ref, need, dt in ((dx, xa.grad, need_x, xd),
                               (dw, wa.grad, need_w, wd)):
        if not need:
            assert got is None
            continue
        assert got.dtype == dt and got.shape == ref.shape
        tol = 1e-2 if dt == BF16 else 1e-5
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * scale, (err, scale)


def test_meta_device_gives_shapes():
    norm = RMSNorm(512, device="meta", dtype=BF16)
    x = torch.empty(2, 4, 576, device="meta", dtype=BF16)[..., :512]
    y = norm(x)
    assert y.shape == (2, 4, 512) and y.device.type == "meta"


def test_profile_shapes_and_bytes():
    assert profile_rmsnorm.parse_shape("16384x768") == (16384, 768, 768)
    assert profile_rmsnorm.parse_shape("16384x512/576") == (16384, 512, 576)
    # bf16 in and out, a bf16 weight read once
    assert profile_rmsnorm.bytes_of(16384, 768) == 16384 * 768 * 4 + 1536


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# rows x d, and the row stride (the kv_a slice: 512 of 576)
SHAPES = [(1, 768, 768), (512, 768, 768), (5120, 768, 768),
          (16384, 768, 768), (16384, 2048, 2048), (16384, 512, 576),
          (300, 1000, 1000), (7, 8, 8)]


def _inputs(rows, d, stride, xd, wd, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + rows + d)
    x = (3 * torch.randn((rows, stride), generator=g, device=dev)).to(xd)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(wd)
    return x[:, :d], w


def _ordered(b):
    """bf16 bit patterns as integers in the order of their values."""
    i = b.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(i >= 0x8000, -(i & 0x7FFF), i)


def _assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == BF16:
        ulps = (_ordered(got) - _ordered(want)).abs().max().item()
        assert ulps <= 1, f"{ulps} bf16 ulps"
    else:
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        assert rel <= 2e-6, rel


@pytest.mark.cuda
@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("rows,d,stride", SHAPES)
def test_kernel_matches_the_composition(card, rows, d, stride, xd, wd):
    x, w = _inputs(rows, d, stride, xd, wd, card)
    before = R.launch_count()
    with torch.inference_mode():
        got = R.rmsnorm(x, w, 1e-6)
        again = R.rmsnorm(x, w, 1e-6)
        want = R.rmsnorm_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    assert R.launch_count() == before + 2
    assert got.is_contiguous()
    _assert_close(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("rows,d,stride", [(5120, 768, 768),
                                           (16384, 512, 576)])
def test_graph_replay_is_bitwise_the_eager_call(card, rows, d, stride, xd,
                                                wd):
    x, w = _inputs(rows, d, stride, xd, wd, card, seed=1)
    with torch.inference_mode():
        eager = R.rmsnorm(x, w, 1e-6)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            R.rmsnorm(x, w, 1e-6)                   # warm up on the side
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            out = R.rmsnorm(x, w, 1e-6)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    with torch.inference_mode():
        with pytest.raises(ValueError, match="x dtype"):
            R.rmsnorm(torch.ones(4, 768, device=card, dtype=F16),
                      torch.ones(768, device=card, dtype=F16), 1e-6)
        with pytest.raises(ValueError, match="multiple of 8"):
            R.rmsnorm(torch.ones(4, 100, device=card, dtype=BF16),
                      torch.ones(100, device=card, dtype=BF16), 1e-6)
        with pytest.raises(ValueError, match="contiguous"):
            R.rmsnorm(torch.ones(4, 1536, device=card, dtype=BF16)[:, ::2],
                      torch.ones(768, device=card, dtype=BF16), 1e-6)
        with pytest.raises(ValueError, match="weight"):
            R.rmsnorm(torch.ones(4, 768, device=card, dtype=BF16),
                      torch.ones(768, 2, device=card, dtype=BF16)[:, 0], 1e-6)


@pytest.mark.cuda
def test_module_routes_on_the_card(card):
    norm = RMSNorm(768, device=card, dtype=BF16)
    x = torch.randn(2, 3, 768, device=card).to(BF16)
    before = R.launch_count()
    with torch.inference_mode():
        y = norm(x)
    assert R.launch_count() == before + 1
    _assert_close(y, _composition(x, norm.weight, 1e-6))
    # autograd records: the kernel, and a gradient
    norm.weight.requires_grad_(True)
    z = norm(x)
    assert R.launch_count() == before + 2
    _assert_close(z, _composition(x, norm.weight, 1e-6))
    z.float().sum().backward()
    assert norm.weight.grad is not None
    # autocast's f32 weight beside a bf16 x, outside autograd
    norm32 = RMSNorm(768, device=card)
    with torch.inference_mode(), torch.autocast("cuda", dtype=BF16):
        y = norm32(x)
    assert y.dtype == BF16 and R.launch_count() == before + 3
    _assert_close(y, _composition(x, norm32.weight, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("xd,wd", DTYPE_PAIRS)
@pytest.mark.parametrize("rows,d,stride", [(512, 768, 768),
                                           (4096, 512, 576)])
def test_gradients_through_the_kernel(card, rows, d, stride, xd, wd):
    x, w = _inputs(rows, d, stride, xd, wd, card, seed=2)
    go = torch.randn(rows, d, device=card).to(xd)
    xk = x.detach().requires_grad_(True)
    wk = w.detach().requires_grad_(True)
    before = R.launch_count()
    yk = R.rmsnorm(xk, wk, 1e-6)
    assert R.launch_count() == before + 1
    yk.backward(go)
    xp = x.detach().requires_grad_(True)
    wp = w.detach().requires_grad_(True)
    yp = _composition(xp, wp, 1e-6)
    yp.backward(go)
    _assert_close(yk.detach(), yp.detach())
    for got, ref in ((xk.grad, xp.grad), (wk.grad, wp.grad)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        tol = 1e-2 if got.dtype == BF16 else 1e-5
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * scale, (err, scale)
