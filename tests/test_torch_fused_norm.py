"""The fused BatchNorm + LeakyReLU of the conv blocks (``ops/fused_norm.py``)
and the blocks' choice of it (``models/vae.py`` ``norm_leaky_relu``).

On the CPU: a block on the CPU runs the port's ``BatchNorm`` and
``F.leaky_relu`` (the plain version), bitwise, forward and backward, train
and eval, in f32 and bf16, on a dense and on a cropped channels-last
input; the running averages, the remat guard and the clamp on a constant
channel, which the kernels copy; which norm kinds take the fused operation
on a card, with the counters; the operators' shapes and gradient wiring on
meta tensors; the replay of a graph's launch counts; the kernels' index
arithmetic and input checks.

On a CUDA card (skipped without one; on the card run ``python -m pytest
tests/test_torch_fused_norm.py --noconftest -q -m card``): the kernels
against the plain version and an f64 recomputation at the layer shapes of
the benchmark's three batch-2048 cells, in bf16 and f32; two runs bitwise
equal; a CUDA graph's capture and replay equal to the eager call; an
exported block calling the operators.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.models import vae
from midi_vae_tpu_torch.models.vae import BatchNorm, ConvBlock, DeconvBlock, GroupNorm, SubsampledBatchNorm
from midi_vae_tpu_torch.ops import fused_norm
from midi_vae_tpu_torch.ops.fused_norm import batch_norm_leaky_relu
from midi_vae_tpu_torch.parallel.collectives import CrossRank
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SLOPE = 0.01
CLAMPED = 2.7  # a constant channel of 2.7 gives E[x²] − E[x]² < 0 in f32: the clamp is active


@pytest.fixture(autouse=True)
def _forget_counters():
    tracing.reset()
    yield
    tracing.reset()


def _layer(c: int, dtype, seed: int = 0, device="cpu") -> BatchNorm:
    g = torch.Generator().manual_seed(seed)
    layer = BatchNorm(c, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(0.5 + torch.rand(c, generator=g))
        layer.bias.copy_(torch.randn(c, generator=g))
        layer.running_mean.copy_(0.3 * torch.randn(c, generator=g))
        layer.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return layer.to(device)


def _input(b, c, h, w, dtype, *, crop=False, seed=1, device="cpu") -> torch.Tensor:
    """A channels-last NCHW activation as the conv blocks hand it over; with
    ``crop``, the [:, :, :h, :w] view of an (h+1)×(w+1) one, as
    ``DeconvBlock``'s transposed conv leaves it. Channel 1 is constant
    (the variance clamp)."""
    g = torch.Generator(device).manual_seed(seed)
    full = 1.5 * torch.randn(b, h + crop, w + crop, c, generator=g, device=device) + 0.2
    full[..., 1] = CLAMPED
    x = full.to(dtype).permute(0, 3, 1, 2)
    return x[:, :, :h, :w] if crop else x


def _fused(layer: BatchNorm, x, train: bool, update: bool = True):
    return batch_norm_leaky_relu(x, layer.weight, layer.bias, layer.running_mean, layer.running_var, train=train,
                                 update=update, momentum=layer.momentum, eps=layer.epsilon, dtype=layer.dtype,
                                 slope=SLOPE)


def _plain(layer: BatchNorm, x, train: bool):
    """The plain version: the port's BatchNorm, then the activation."""
    return F.leaky_relu(layer(x, train), SLOPE)


def _grads(y, tensors, seed=2):
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(y.shape, generator=g).to(device=y.device, dtype=y.dtype)
    return torch.autograd.grad(y, tensors, dy)


def _block(norm: str, c: int = 8):
    return ConvBlock(c, c, stride=1, norm=norm, generator=torch.Generator().manual_seed(0))


def _as_if_on_a_card(monkeypatch, calls: list):
    """Make the blocks take the fused path on CPU tensors, with the
    operation replaced by the plain version on the layer's tensors."""

    def fused(x, weight, bias, running_mean, running_var, *, train, update, momentum, eps, dtype, slope):
        calls.append(update)
        layer = BatchNorm(x.shape[1], dtype=dtype, momentum=momentum, epsilon=eps)
        layer.weight, layer.bias = weight, bias
        layer.running_mean, layer.running_var = running_mean, running_var
        with vae._recomputing() if not update and train else torch.enable_grad():
            return F.leaky_relu(layer(x, train), slope)

    monkeypatch.setattr(vae, "_on_a_card", lambda t: True)
    monkeypatch.setattr(vae, "batch_norm_leaky_relu", fused)


# ------------------------------------------------------------------ CPU: the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("crop", [False, True])
def test_a_cpu_block_runs_batchnorm_then_leaky_relu_bitwise(monkeypatch, dtype, train, crop):
    monkeypatch.setattr(vae, "batch_norm_leaky_relu", lambda *a, **k: pytest.fail("the kernels on the CPU"))
    block = DeconvBlock(12, 12, dtype=dtype, generator=torch.Generator().manual_seed(0))
    block.BatchNorm_0.load_state_dict(_layer(12, dtype).state_dict())
    today = _layer(12, dtype)
    x = _input(3, 12, 5, 6, dtype, crop=crop)
    xa, xb = x.detach().requires_grad_(), x.detach().requires_grad_()
    ya = _plain(today, xa, train)
    yb = vae.norm_leaky_relu(block, xb, train)
    assert yb.dtype == ya.dtype == dtype and yb.stride() == ya.stride()
    assert torch.equal(ya, yb)
    ga = _grads(ya, (xa, today.weight, today.bias))
    gb = _grads(yb, (xb, block.BatchNorm_0.weight, block.BatchNorm_0.bias))
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(today, name), getattr(block.BatchNorm_0, name)), name
    assert tracing.counters() == {"norm.batch_calls": 1}


def test_running_averages_move_once_and_not_in_a_recompute(monkeypatch):
    """The fused path asks for no update inside a remat recompute."""
    calls = []
    _as_if_on_a_card(monkeypatch, calls)
    layer = _layer(8, torch.float32)
    before = (layer.running_mean.clone(), layer.running_var.clone())
    x = _input(4, 8, 3, 3, torch.float32)
    block = ConvBlock(8, 8, stride=1, generator=torch.Generator().manual_seed(0))
    block.BatchNorm_0.load_state_dict(layer.state_dict())
    with vae._recomputing():
        vae.norm_leaky_relu(block, x, True)
    assert calls == [False] and torch.equal(block.BatchNorm_0.running_mean, before[0])
    vae.norm_leaky_relu(block, x, True)
    assert calls == [False, True]
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    assert torch.equal(block.BatchNorm_0.running_mean, 0.9 * before[0] + (1.0 - 0.9) * mean)
    assert torch.equal(block.BatchNorm_0.running_var, 0.9 * before[1] + (1.0 - 0.9) * var)


def test_the_clamped_channel_takes_no_variance_gradient():
    """On the constant channel E[x²] − E[x]² rounds below 0: the clamp sets
    the variance to 0 and passes it no gradient, so ∂x there is
    scale·rstd·(dz − mean dz), as the plain version's autograd gives it and
    the kernels' variance gate copies."""
    layer = _layer(4, torch.float32)
    x = _input(4, 4, 6, 6, torch.float32).detach().requires_grad_()
    x32 = x.detach().float()
    raw = (x32 * x32).mean(dim=(0, 2, 3)) - x32.mean(dim=(0, 2, 3)) ** 2
    assert raw[1] < 0 < raw[0]
    y = _plain(layer, x, True)
    (gx,) = _grads(y, (x,))
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    dz = torch.where(y > 0, dy, dy * SLOPE)[:, 1]
    mul = float(layer.weight.detach()[1]) / math.sqrt(layer.epsilon)
    assert torch.allclose(gx[:, 1], mul * (dz - dz.mean()), rtol=1e-5, atol=1e-5 * mul)
    assert torch.isfinite(gx).all()


# ------------------------------------------------------------------ CPU: who takes the fused operation


@pytest.mark.parametrize("norm, fused", [("batch", True), ("batch-sub2", False), ("group", False), ("none", False)])
def test_only_batchnorm_itself_is_fused(monkeypatch, norm, fused):
    calls = []
    _as_if_on_a_card(monkeypatch, calls)
    block, x = _block(norm), _input(4, 8, 4, 4, torch.float32)
    y = block(x, True)
    assert len(calls) == int(fused)
    kinds = {"batch": BatchNorm, "batch-sub2": SubsampledBatchNorm, "group": GroupNorm}
    if norm in kinds:
        assert type(getattr(block, block.norm_name)) is kinds[norm]
    counts = tracing.counters()
    assert counts.get("norm.batch_calls", 0) == counts.get("norm.fused_calls", 0) == int(fused)
    plain_block = _block(norm)
    ref = F.leaky_relu(vae.apply_norm(plain_block, plain_block.Conv_0(x), True), SLOPE)
    assert torch.equal(y, ref)


def test_batchnorm_across_ranks_keeps_the_unfused_path(monkeypatch):
    _as_if_on_a_card(monkeypatch, [])
    monkeypatch.setattr(vae, "batch_norm_leaky_relu", lambda *a, **k: pytest.fail("fused across ranks"))
    monkeypatch.setattr(vae, "cross_rank_means", lambda layer, *means: means)  # two ranks of equal shards
    monkeypatch.setattr(vae, "group_size", lambda group: 2)
    block = DeconvBlock(8, 8, generator=torch.Generator().manual_seed(0))
    block.BatchNorm_0.cross_rank = CrossRank(None)
    x = _input(2, 8, 3, 3, torch.float32)
    y = block(x, True)
    assert y.shape == (2, 8, 6, 6)
    assert tracing.counters() == {"norm.batch_calls": 1}


def test_a_group_of_one_rank_is_fused(monkeypatch):
    """Over one rank the statistics' mean is the local one: no all-reduce
    is needed, and the layer takes the kernels as it does with no group."""
    calls = []
    _as_if_on_a_card(monkeypatch, calls)
    monkeypatch.setattr(vae, "group_size", lambda group: 1)
    block = DeconvBlock(8, 8, generator=torch.Generator().manual_seed(0))
    block.BatchNorm_0.cross_rank = CrossRank(None)
    block(_input(2, 8, 3, 3, torch.float32), True)
    assert calls == [True] and tracing.counters() == {"norm.batch_calls": 1, "norm.fused_calls": 1}


def test_counters_count_batchnorm_calls_and_those_fused(monkeypatch):
    block, x = _block("batch"), _input(2, 8, 4, 4, torch.float32)
    block(x, True)
    assert tracing.counters() == {"norm.batch_calls": 1}  # the CPU takes no kernel
    tracing.reset()
    _as_if_on_a_card(monkeypatch, [])
    block(x, True)
    with torch.no_grad():
        block(x, False)
    assert tracing.counters() == {"norm.batch_calls": 2, "norm.fused_calls": 2}
    tracing.reset()
    _block("group")(x, True)
    assert tracing.counters() == {}


# ------------------------------------------------------------------ CPU: the operators around the kernels


def test_the_kernels_take_cuda_tensors_only():
    layer = _layer(8, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        _fused(layer, _input(2, 8, 3, 3, torch.float32), True)
    with pytest.raises(ValueError, match="one CUDA device"):
        _fused(_layer(8, torch.float32, device="meta"), torch.empty(2, 8, 3, 3, device="meta"), True)
    assert fused_norm.launch_counts() == {"BN": 0, "BN-bwd": 0}


@pytest.mark.parametrize("train", [True, False])
def test_operators_give_shapes_and_gradients_on_meta_tensors(train):
    """What ``torch.export`` records from the operators' fake versions: y in
    the block's dtype and laid out as ``empty_like(x)`` (a cropped
    channels-last view gives a channels-last y), f32 [3, C] statistics;
    autograd's backward through the gradient operator gives dx like x and
    the parameters' gradients in their dtype; the statistics steps declare
    what they write."""
    x = torch.empty(2, 9, 9, 8, device="meta", dtype=torch.bfloat16).permute(0, 3, 1, 2)[:, :, :8, :8]
    x.requires_grad_()
    w = torch.ones(8, device="meta", requires_grad=True)
    b = torch.zeros(8, device="meta", requires_grad=True)
    rm, rv = torch.zeros(8, device="meta"), torch.ones(8, device="meta")
    if train:
        stats = fused_norm._train_stats(x.detach(), rm, rv, True, 0.9, 1e-5)
    else:
        stats = fused_norm._eval_stats(rm, rv, 1e-5)
    assert stats.shape == (3, 8) and stats.dtype == torch.float32
    y = fused_norm._apply(x, w, b, stats, train, torch.bfloat16, SLOPE)
    assert y.dtype == torch.bfloat16 and y.stride() == torch.empty_like(x).stride() == (512, 1, 64, 8)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), torch.empty_like(y))
    assert gx.shape == x.shape and gx.dtype == x.dtype and gw.dtype == gb.dtype == torch.float32
    schema = torch.ops.midi_vae_tpu_torch.batch_norm_train_stats.default._schema
    assert [a.name for a in schema.arguments if a.is_write] == ["running_mean", "running_var"]
    assert not any(a.is_write for a in torch.ops.midi_vae_tpu_torch.batch_norm_leaky_relu.default._schema.arguments)


def test_a_traced_call_records_the_operators_and_an_eager_one_calls_the_kernels(monkeypatch):
    """Under ``torch.export`` or ``torch.compile`` the call goes through the
    registered operators (here their fake versions, on meta tensors);
    eagerly, through the one autograd node that launches the kernels."""
    monkeypatch.setattr(fused_norm, "_on_one_card", lambda *tensors: True)
    layer = _layer(8, torch.bfloat16, device="meta")
    x = torch.empty(2, 8, 3, 3, device="meta", dtype=torch.bfloat16)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    monkeypatch.setattr(fused_norm._BatchNormLeakyReLU, "apply", lambda *a: pytest.fail("the eager node traced"))
    for train in (True, False):
        y = _fused(layer, x, train)
        assert y.device.type == "meta" and y.dtype == torch.bfloat16 and y.shape == x.shape
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    calls = []
    monkeypatch.setattr(fused_norm._BatchNormLeakyReLU, "apply", lambda *a: calls.append(a) or a[0])
    for op in ("_train_stats", "_eval_stats", "_apply"):
        monkeypatch.setattr(fused_norm, op, lambda *a: pytest.fail("an operator called eagerly"))
    assert _fused(layer, x, True) is x and len(calls) == 1


def test_a_graph_replay_adds_the_launches_its_capture_held(monkeypatch):
    from midi_vae_tpu_torch.train import graphs

    class Graph:
        def replay(self):
            pass

    fused_norm.reset_launch_counts()
    x = torch.zeros(2, 3)
    held = ({"BN": 4, "BN-bwd": 0}, {"BN": 0, "BN-bwd": 4})
    g = graphs._Graphed(Graph(), Graph(), (x,), (x,), [torch.zeros(2, 3)], [None], [], [], held)
    g.replay_forward((x,))
    assert fused_norm.launch_counts() == {"BN": 4, "BN-bwd": 0}
    g.replay_backward((torch.ones(2, 3),))
    g.replay_forward((x,))
    assert fused_norm.launch_counts() == {"BN": 8, "BN-bwd": 4}
    fused_norm.reset_launch_counts()


def test_strides_and_grid_of_a_cropped_view():
    x = _input(3, 48, 16, 16, torch.bfloat16, crop=True)
    assert fused_norm._strides(x) == (17 * 17 * 48, 17 * 48, 48, 1)
    pixels, hw, w, n_tiles, n_cb = fused_norm._grid_sizes(x)
    assert (pixels, hw, w, n_tiles, n_cb) == (768, 256, 16, 6, 2)
    # every pixel's offset, as the kernels compute it, addresses x's element
    p = torch.arange(pixels)
    n, r = p // hw, p % hw
    sn, sh, sw, sc = fused_norm._strides(x)
    off = n * sn + (r // w) * sh + (r % w) * sw
    storage = torch.as_strided(x, (x.untyped_storage().nbytes() // x.element_size(),), (1,), 0)
    assert torch.equal(storage[off[:, None] + torch.arange(48)[None, :] * sc], x.permute(0, 2, 3, 1).reshape(-1, 48))
    assert fused_norm._reduce_programs(n_tiles, n_cb) == n_tiles
    assert fused_norm._reduce_programs(1024, 8) == fused_norm._REDUCE_PROGRAMS // 8


def test_wrapper_checks_what_the_kernels_take():
    layer = _layer(8, torch.float32)
    args = (layer.weight, layer.bias, layer.running_mean, layer.running_var)
    with pytest.raises(ValueError, match="NCHW"):
        fused_norm._check_inputs(torch.zeros(2, 8, 3), *args)
    with pytest.raises(TypeError, match="float"):
        fused_norm._check_inputs(torch.zeros(2, 8, 3, 3, dtype=torch.int32), *args)
    with pytest.raises(ValueError, match="per-channel"):
        fused_norm._check_inputs(torch.zeros(2, 4, 3, 3), *args)
    with pytest.raises(ValueError, match="pixels"):
        fused_norm._check_inputs(torch.zeros(0, 8, 3, 3), *args)
    with pytest.raises(ValueError, match="int32"):
        fused_norm._strides(torch.empty_strided((2**16, 1, 2**8, 2**8), (2**16, 1, 2**8, 1), device="meta"))


# ------------------------------------------------------------------ the card

# (C, H, W, cropped) of every BatchNorm layer of the benchmark's batch-2048 cells, and the batch tested
FLAGSHIP = [(48, 8, 8, False), (64, 8, 8, False), (128, 8, 8, False), (256, 8, 8, False),
            (48, 16, 16, True), (48, 16, 16, False)]
VANILLA = [(32, 64, 64, False), (64, 32, 32, False), (128, 16, 16, False), (256, 8, 8, False),
           (128, 16, 16, True), (64, 32, 32, True), (32, 64, 64, True), (32, 128, 128, True)]
VQ16 = [(64, 16, 16, False), (128, 16, 16, False), (256, 16, 16, False)]
# the cells' own batch, but vanilla's layers at 256: the f64 reference of its [2048, 32, 128, 128]
# layer would take ~40 GB
CARD_SHAPES = ([(2048, *s) for s in FLAGSHIP + VQ16] + [(256, *s) for s in VANILLA])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are Triton, compiled and run there only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """Spacing of ``dtype``'s numbers at |x|, in f64."""
    info = torch.finfo(dtype)
    _, e = torch.frexp(x.abs().clamp_min(info.tiny))
    return torch.ldexp(torch.full_like(x, info.eps), e - 1)


def _reference_backward(x, dy, weight, mean, rstd, gate, y, dtype):
    """(dx, ∂scale, ∂bias) in f64 from the kernels' own statistics, and the
    sizes their f32 rounding scales with; the activation's mask comes from
    the kernels' output (LeakyReLU keeps the sign)."""
    dz = torch.where(y > 0, dy.double(), (dy * SLOPE).to(dtype).double())
    xhat = (x.double() - mean.double()[:, None, None]) * rstd.double()[:, None, None]
    m = x.shape[0] * x.shape[2] * x.shape[3]
    sdz, sdzx = dz.sum(dim=(0, 2, 3)), (dz * xhat).sum(dim=(0, 2, 3))
    mul = (rstd.double() * weight.double())[:, None, None]
    dx = mul * (dz - (sdz / m)[:, None, None] - xhat * (gate.double() * sdzx / m)[:, None, None])
    adz, axhat = dz.abs(), xhat.abs()
    size = mul * (adz + adz.mean(dim=(0, 2, 3), keepdim=True) + axhat * (adz * axhat).mean(dim=(0, 2, 3), keepdim=True))
    return dx, sdzx, sdz, size, (adz * axhat).sum(dim=(0, 2, 3)), adz.sum(dim=(0, 2, 3))


def _fwd(layer, x, momentum, dtype):
    """(y, stats) of the kernels in train mode, the running averages moved at ``momentum``."""
    stats = fused_norm._train_stats(x, layer.running_mean, layer.running_var, True, momentum, layer.epsilon)
    return fused_norm._apply(x, layer.weight, layer.bias, stats, True, dtype, SLOPE), stats


def _given(layer, mean, var):
    """A copy of ``layer`` whose running averages are ``mean`` and ``var``:
    in eval mode, the plain version on those statistics."""
    given = _layer(layer.weight.shape[0], layer.dtype, device=layer.weight.device)
    given.load_state_dict({**layer.state_dict(), "running_mean": mean, "running_var": var})
    return given


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_plain_version(card, shape, dtype):
    """Tolerances, each with its reason:

    - statistics: the kernels sum in another order than torch's reduction,
      so the mean and the variance differ from an f64 recomputation by the
      f32 rounding of the sums (1e-5 of √E[x²] and of E[x²]);
    - output and running averages: bitwise the plain version's given the
      kernels' statistics, which a momentum of 0 copies into the running
      averages exactly;
    - dx: within one unit in the last place of its dtype of the f64 closed
      form on the same statistics, plus 64 f32 ulps of the form's terms
      (the rounding of the two per-channel sums, ~n_tiles/G + 13 additions
      deep, and of the elementwise steps);
    - ∂scale, ∂bias: the f32 sums against f64 (1e-5 of Σ|dz·x̂| and Σ|dz|);
    - against the plain version's autograd, which rounds its own statistics
      and its three-path gradient another way: dx within 1e-2 of its norm
      (an element whose pre-activation rounds across 0 takes the other
      slope, 100× apart), over every channel but the constant one, whose
      variance is rounding noise of the order of ε, so that its rstd, and
      its dx with it, differ between any two summation orders.
    """
    b, c, h, w, crop = shape
    x = _input(b, c, h, w, dtype, crop=crop, device=card)

    probe = _layer(c, dtype, device=card)
    y, stats = _fwd(probe, x, 0.0, dtype)
    mean, var = probe.running_mean, probe.running_var  # the kernels' batch statistics, exactly
    assert torch.equal(stats[0], mean)
    x64 = x.double()
    mean64 = x64.mean(dim=(0, 2, 3))
    ex2 = (x64 * x64).mean(dim=(0, 2, 3))
    raw64 = ex2 - mean64 * mean64
    assert ((mean.double() - mean64).abs() <= 1e-5 * ex2.sqrt()).all()
    assert ((var.double() - raw64.clamp_min(0.0)).abs() <= 1e-5 * ex2).all()
    gate = stats[2]
    assert bool(((gate == 0) | (gate == 1)).all()) and bool((gate[raw64 > 1e-3 * ex2] == 1).all())

    # the output, bitwise the plain version's on the same statistics and laid out as the eager path lays it out
    y_plain = _plain(_given(probe, mean, var), x, False)
    assert y.dtype == dtype and y.stride() == y_plain.stride()
    assert torch.equal(y, y_plain), f"{int((y != y_plain).sum())} outputs differ"

    # the running averages at the layer's momentum, bitwise the plain version's update; the same output again
    layer = _layer(c, dtype, device=card)
    old = (layer.running_mean.clone(), layer.running_var.clone())
    y2, stats2 = _fwd(layer, x, layer.momentum, dtype)
    assert torch.equal(y2, y) and torch.equal(stats2, stats)
    for got, prev, batch in zip((layer.running_mean, layer.running_var), old, (mean, var)):
        assert torch.equal(got, layer.momentum * prev + (1.0 - layer.momentum) * batch)

    # the backward against the f64 closed form on the kernels' statistics
    dy = torch.randn(b, h, w, c, generator=torch.Generator(card).manual_seed(2), device=card)
    dy = dy.to(dtype).permute(0, 3, 1, 2)
    dx, dw, db = fused_norm.batch_norm_leaky_relu_grad(x, dy, layer.weight, layer.bias, stats, train=True,
                                                       slope=SLOPE)
    rdx, rdw, rdb, size, sum_dzx, sum_dz = _reference_backward(x, dy, layer.weight, mean, stats[1], gate, y, dtype)
    assert dx.dtype == dtype and dx.stride() == torch.empty_like(x).stride()
    f32_eps = torch.finfo(torch.float32).eps
    within = (dx.double() - rdx).abs() <= _ulp(rdx, dtype) + 64 * f32_eps * size
    assert bool(within.all()), f"{int((~within).sum())} of dx beyond tolerance"
    assert ((dw.double() - rdw).abs() <= 1e-5 * sum_dzx).all()
    assert ((db.double() - rdb).abs() <= 1e-5 * sum_dz).all()

    # against the plain version's own autograd
    xp = x.detach().requires_grad_()
    yp = _plain(_given(layer, *old), xp, True)
    (gp,) = torch.autograd.grad(yp, xp, dy)
    varied = torch.arange(c, device=card) != 1
    diff, ref = (dx.double() - gp.double())[:, varied], gp.double()[:, varied]
    assert float(diff.norm()) <= 1e-2 * float(ref.norm())


@pytest.mark.card
@pytest.mark.parametrize("crop", [False, True])
def test_kernels_in_eval_mode_and_their_gradient(card, crop):
    """Eval mode normalises with the running averages: the output and dx
    (dz·rstd·scale, one rounding in both) bitwise the plain version's; the
    parameter gradients within the f32 rounding of their sums. dy here is
    contiguous NCHW, so its channels are not the contiguous axis."""
    layer = _layer(48, torch.bfloat16, device=card)
    x = _input(512, 48, 16, 16, torch.bfloat16, crop=crop, device=card).detach().requires_grad_()
    before = (layer.running_mean.clone(), layer.running_var.clone())
    y = _fused(layer, x, False)
    xp = x.detach().requires_grad_()
    plain = _given(layer, *before)
    yp = _plain(plain, xp, False)
    assert torch.equal(y, yp), f"{int((y != yp).sum())} outputs differ"
    assert torch.equal(layer.running_mean, before[0]) and torch.equal(layer.running_var, before[1])
    dy = torch.randn(y.shape, generator=torch.Generator(card).manual_seed(3), device=card).to(torch.bfloat16)
    gx, gw, gb = torch.autograd.grad(y, (x, layer.weight, layer.bias), dy)
    px, pw, pb = torch.autograd.grad(yp, (xp, plain.weight, plain.bias), dy)
    assert torch.equal(gx, px), f"{int((gx != px).sum())} of dx differ"
    dz = torch.where(yp > 0, dy.double(), (dy * SLOPE).to(torch.bfloat16).double())
    xhat = (x.double() - before[0].double()[:, None, None]) * torch.rsqrt(before[1].double() + 1e-5)[:, None, None]
    assert ((gw.double() - pw.double()).abs() <= 1e-5 * (dz * xhat).abs().sum(dim=(0, 2, 3))).all()
    assert ((gb.double() - pb.double()).abs() <= 1e-5 * dz.abs().sum(dim=(0, 2, 3))).all()


@pytest.mark.card
def test_two_runs_are_bitwise_and_a_graph_replays_the_eager_call(card):
    b, c, h, w = 2048, 48, 16, 16
    dy = torch.randn(b, c, h, w, device=card).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def leaf():
        return _input(b, c, h, w, torch.bfloat16, crop=True, device=card).detach().requires_grad_()

    def run(layer, x):
        y = _fused(layer, x, True)
        return (y, *torch.autograd.grad(y, (x, layer.weight, layer.bias), dy), layer.running_mean.clone(),
                layer.running_var.clone())

    first = run(_layer(c, torch.bfloat16, device=card), leaf())
    second = run(_layer(c, torch.bfloat16, device=card), leaf())
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    launches = batch_norm_leaky_relu.launches

    # warm-up and capture on a side stream, in thread-local mode, as train/graphs.py captures the step; the
    # leaves are made for it (autograd runs a leaf's gradient on the stream where it was first used)
    layer, x = _layer(c, torch.bfloat16, device=card), leaf()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        run(_layer(c, torch.bfloat16, device=card), x)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        captured = run(layer, x)
    graph.replay()
    torch.cuda.synchronize(card)
    assert all(torch.equal(a, b) for a, b in zip(first, captured))
    assert batch_norm_leaky_relu.launches == launches + 2  # the warm-up and the capture; replays launch from C++


@pytest.mark.card
def test_an_exported_block_calls_the_operators(card):
    """``torch.export`` of a block on the card records the fused operators,
    not the plain version, and the exported program gives the eager
    block's output bitwise, launching the kernels."""
    from torch.export import Dim, export

    block = DeconvBlock(48, 48, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).to(card)
    block.BatchNorm_0.load_state_dict(_layer(48, torch.bfloat16, device=card).state_dict())

    class Eval(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block(x, False)

    x = _input(4, 48, 8, 8, torch.bfloat16, device=card).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        program = export(Eval(), (x,), dynamic_shapes=({0: Dim("b")},))
        targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
        assert {"midi_vae_tpu_torch.batch_norm_eval_stats.default",
                "midi_vae_tpu_torch.batch_norm_leaky_relu.default"} <= targets, targets
        assert not [t for t in targets if "batch_norm" in t and "midi_vae_tpu_torch" not in t], targets
        launches = batch_norm_leaky_relu.launches
        want = block(x, False)
        got = program.module()(x)
    assert batch_norm_leaky_relu.launches == launches + 2
    assert torch.equal(got, want)
