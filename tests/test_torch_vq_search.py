"""The VQ quantizer's search and sum kernels (``ops/vq_search.py``) and
the quantizer's choice of them (``models/vq.py``).

On the CPU: the quantizer takes the plain version, counts its calls in
``vq.calls`` and none in ``vq.fused_calls`` (absent there, as
``norm.fused_calls`` is), and gives bitwise what the quantizer gave
before the kernels existed (the distance matrix, argmin,
gather and ``index_add_`` written out below), forward and EMA update, in
f32 and bf16; the operators' shapes on meta tensors; the input checks;
the benchmark's reader of the kernels' share.

On a CUDA card (skipped without one; on the card run ``python -m pytest
tests/test_torch_vq_search.py --noconftest -q -m card``): the kernels
against the plain version at N ∈ {1, 255, 25,600, 524,288} and (K, D) ∈
{(3, 2), (16, 4), (512, 16), (1024, 64)}, z in bf16 and f32: indices equal
except at near-ties (``tests/test_torch_vq.py``'s rule: the two codes'
plain distances within 1e-5 relative), z_q bitwise the codebook's rows,
counts exact, sums within f32 reordering of an f64 sum; a duplicated code
gives the first index; a train-mode call makes no host sync; two runs
give the same indices and counts bitwise and the same sums to f32
reordering (the block sums' shared-memory atomics), and a CUDA graph
replays the eager call; a VQ artifact
exported for ``cuda`` records the operators and serves the live model's
output.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from midi_vae_tpu_torch.io import tracing
from midi_vae_tpu_torch.models.vq import VectorQuantizerEMA
from midi_vae_tpu_torch.ops import vq_search
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_READER = Path(__file__).resolve().parents[1] / "bench_cuda" / "metrics" / "fused_quantizer_share.train.py"


@pytest.fixture(autouse=True)
def _forget_counters():
    tracing.reset()
    yield
    tracing.reset()


def _quantizer(k, d, seed=0, device="cpu") -> VectorQuantizerEMA:
    q = VectorQuantizerEMA(k, d, generator=torch.Generator().manual_seed(seed))
    return q.to(device)


def _z(shape, dtype, seed=1, device="cpu") -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device=device, dtype=dtype)


# ------------------------------------------------------------------ the quantizer before the kernels


def _before_distances(q, flat):
    cb = q.codebook
    cross = (flat.double() @ cb.double().T).float()
    return torch.sum(flat * flat, dim=1, keepdim=True) - 2.0 * cross + torch.sum(cb * cb, dim=1)[None, :]


@torch.no_grad()
def _before_ema_update(q, flat, idx):
    k = q.num_codes
    counts = flat.new_zeros(k).index_add_(0, idx, flat.new_ones(idx.shape[0]))
    dw = torch.zeros_like(q.embed_avg).index_add_(0, idx, flat.detach())
    d = np.float32(q.decay)
    one_minus = float(np.float32(1.0) - d)
    new_cs = q.cluster_size * float(d) + counts * one_minus
    new_ea = q.embed_avg * float(d) + dw * one_minus
    n = torch.sum(new_cs)
    smoothed = (new_cs + q.epsilon) / (n + k * q.epsilon) * n
    q.cluster_size.copy_(new_cs)
    q.embed_avg.copy_(new_ea)
    q.codebook.copy_(new_ea / smoothed[:, None])


def _before_forward(q, z_e, train):
    flat = z_e.reshape(-1, q.embed_dim).float()
    with torch.no_grad():
        idx = torch.argmin(_before_distances(q, flat), dim=1)
        z_q = q.codebook.index_select(0, idx)
    z_e32 = z_e.float()
    z_st = z_e32 + (z_q.reshape(z_e.shape) - z_e32).detach()
    if train:
        _before_ema_update(q, flat, idx)
    return z_st, idx.reshape(z_e.shape[:-1])


def _buffers(q):
    return [b.clone() for b in (q.codebook, q.cluster_size, q.embed_avg)]


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_the_cpu_takes_the_plain_version_bitwise_as_before(dtype, train):
    q, before = _quantizer(32, 4), _quantizer(32, 4)
    z_e = _z((3, 5, 5, 4), dtype)
    launches = (vq_search.nearest_codes.launches, vq_search.code_sums.launches)
    for _ in range(2):  # the second call sees the first one's update
        st, idx = q(z_e, train)
        want_st, want_idx = _before_forward(before, z_e, train)
        assert torch.equal(st, want_st) and torch.equal(idx, want_idx) and st.dtype == torch.float32
        assert all(torch.equal(a, b) for a, b in zip(_buffers(q), _buffers(before)))
    assert (vq_search.nearest_codes.launches, vq_search.code_sums.launches) == launches
    counts = tracing.counters()
    assert counts["vq.calls"] == 2 and counts["vq.vectors"] == 2 * 75 and "vq.fused_calls" not in counts


def test_the_split_out_plain_functions_are_the_update_and_distances_as_before():
    q, before = _quantizer(16, 4, seed=2), _quantizer(16, 4, seed=2)
    g = torch.Generator().manual_seed(3)
    flat = torch.randn(300, 4, generator=g)
    idx = torch.randint(0, 16, (300,), generator=g)
    assert torch.equal(q.distances(flat), _before_distances(before, flat))
    assert torch.equal(vq_search.distances_plain(flat, q.codebook), _before_distances(before, flat))
    q._ema_update(flat, idx)
    _before_ema_update(before, flat, idx)
    assert all(torch.equal(a, b) for a, b in zip(_buffers(q), _buffers(before)))
    counts, sums = vq_search.code_sums(flat, idx, None, 16)
    assert torch.equal(counts, torch.bincount(idx, minlength=16).float())
    assert torch.equal(sums, torch.zeros(16, 4).index_add_(0, idx, flat))
    got_idx, z_q, partials = vq_search.nearest_codes(flat, q.codebook, train=True)
    assert partials is None and torch.equal(got_idx, torch.argmin(q.distances(flat), dim=1))
    assert torch.equal(z_q, q.codebook[got_idx])


def test_only_cuda_tensors_with_an_f32_codebook_take_the_kernels():
    flat, cb = torch.zeros(4, 2), torch.zeros(3, 2)
    assert not vq_search.takes_kernels(flat, cb)
    assert not vq_search.takes_kernels(flat.to("meta"), cb.to("meta"))
    q = _quantizer(8, 2).double()  # an f64 model keeps f64 buffers: the plain version, on any device
    st, _ = q(torch.randn(6, 2), True)
    assert st.dtype == torch.float64 and "vq.fused_calls" not in tracing.counters()


@pytest.mark.parametrize("flat, cb, error", [
    (torch.zeros(4, 2), torch.zeros(3, 3), "need flat"),
    (torch.zeros(4, 2, 1), torch.zeros(3, 2), "need flat"),
    (torch.zeros(4, 2, dtype=torch.bfloat16), torch.zeros(3, 2), "f32"),
    (torch.zeros(4, 2), torch.zeros(3, 2, dtype=torch.float64), "f32"),
    (torch.zeros(4, vq_search.MAX_DIM + 1), torch.zeros(3, vq_search.MAX_DIM + 1), "dimensions"),
    (torch.zeros(4, 2), torch.zeros(0, 2), "dimensions"),
], ids=["dims", "rank", "bf16 z", "f64 codebook", "too wide", "no codes"])
def test_the_kernels_refuse_what_they_do_not_take(flat, cb, error):
    with pytest.raises((ValueError, TypeError), match=error):
        vq_search._check_inputs(flat, cb)


@pytest.mark.parametrize("n, blocks", [(0, 1), (1, 1), (25_600, 100), (67_584, 264), (67_585, 133),
                                       (524_288, 256)])
def test_the_search_spreads_its_tiles_evenly_over_the_blocks_the_card_holds(monkeypatch, n, blocks):
    """264 blocks at once (two an SM of 132), 256 vectors a tile: each
    block walks the same number of tiles to within one."""
    monkeypatch.setattr(vq_search, "_capacity", lambda k, d, device_index: (264, 256))
    assert vq_search.search_blocks(n, 512, 16, 0) == blocks


def test_the_operators_give_their_outputs_shapes_on_meta_tensors(monkeypatch):
    """Every call that takes the kernels goes through the registered
    operators (on meta tensors, their fake versions, as under
    ``torch.export``): eval search and the sums; the launchers are not
    called directly, and the search counts one ``vq.fused_calls``."""
    monkeypatch.setattr(vq_search, "takes_kernels", lambda flat, cb: True)
    monkeypatch.setattr(vq_search, "_launch_search", lambda *a: pytest.fail("launched while tracing"))
    monkeypatch.setattr(vq_search, "_launch_sums", lambda *a: pytest.fail("launched while tracing"))
    flat, cb = torch.empty(10, 4, device="meta"), torch.empty(6, 4, device="meta")
    idx, z_q, partials = vq_search.nearest_codes(flat, cb, train=False)
    assert idx.shape == (10,) and idx.dtype == torch.int64 and z_q.shape == (10, 4) and z_q.dtype == torch.float32
    assert partials.shape == (0, 6, 5) and tracing.counters() == {"vq.fused_calls": 1}
    counts, sums = vq_search.code_sums(flat, idx, torch.empty(7, 6, 5, device="meta"), 6)
    assert counts.shape == (6,) and sums.shape == (6, 4) and counts.device.type == "meta"
    for name in ("vq_nearest_codes", "vq_code_sums"):
        schema = getattr(torch.ops.midi_vae_tpu_torch, name).default._schema
        assert not any(a.is_write for a in schema.arguments)


def _reader():
    spec = importlib.util.spec_from_file_location("fused_quantizer_share_train", _READER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_benchmark_reader_reads_the_counters():
    read = _reader().read
    assert read({}) is None  # no quantizer call
    tracing.count("vq.calls", 4)
    assert read({}) is None  # a program without the kernels' counter
    tracing.count("vq.fused_calls", 4)
    assert read({}) == 100.0
    tracing.count("vq.calls", 4)
    assert read({}) == 50.0


# ------------------------------------------------------------------ the card

SIZES = [1, 255, 25_600, 524_288]
CODEBOOKS = [(3, 2), (16, 4), (512, 16), (1024, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++, compiled and run there only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _codebook(k, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(k, d, generator=g) * (0.5 + torch.rand(k, 1, generator=g))).to(device)


def _assert_near_ties_only(got, want, flat, cb):
    """Indices equal; where not, the two codes' plain distances within 1e-5 relative."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel():
        d2 = vq_search.distances_plain(flat[rows], cb).double()
        a, b = d2.gather(1, got[rows, None]), d2.gather(1, want[rows, None])
        assert torch.all((a - b).abs() <= 1e-5 * torch.maximum(a.abs(), b.abs())), (rows[:8], a[:8], b[:8])
    return int(rows.numel())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kd", CODEBOOKS, ids=lambda kd: f"K{kd[0]}-D{kd[1]}")
@pytest.mark.parametrize("n", SIZES, ids=lambda n: f"N{n}")
def test_the_kernels_match_the_plain_version(card, n, kd, dtype):
    k, d = kd
    flat = _z((n, d), dtype, seed=n + k, device=card).float()
    cb = _codebook(k, d, seed=k + d, device=card)
    idx, z_q, partials = vq_search.nearest_codes(flat, cb, train=True)
    counts, sums = vq_search.code_sums(flat, idx, partials, k)
    want_idx, _ = vq_search.nearest_codes_plain(flat, cb)
    _assert_near_ties_only(idx, want_idx, flat, cb)
    assert idx.dtype == torch.int64 and torch.equal(z_q, cb[idx])
    assert torch.equal(counts, torch.bincount(idx, minlength=k).float())
    exact = torch.zeros(k, d, dtype=torch.float64, device=card).index_add_(0, idx, flat.double())
    size = torch.zeros(k, d, dtype=torch.float64, device=card).index_add_(0, idx, flat.double().abs())
    # an f32 sum of m terms in any order is within γ(m - 1)·Σ|terms| of the exact sum, γ(j) = j·u / (1 - j·u)
    ju = (counts.double().clamp_min(1)[:, None] - 1) * 2**-24
    assert torch.all((sums.double() - exact).abs() <= ju / (1 - ju) * size)
    eval_idx, eval_zq, eval_partials = vq_search.nearest_codes(flat, cb, train=False)
    assert torch.equal(eval_idx, idx) and torch.equal(eval_zq, z_q) and eval_partials.shape[0] == 0


@pytest.mark.card
def test_a_duplicated_code_gives_the_first_index(card):
    cb = _codebook(512, 16, seed=5, device=card)
    cb[300] = cb[7]
    cb[511] = cb[7]
    flat = (cb[[7, 300, 511, 7]] + 1e-3).contiguous()
    idx, z_q, _ = vq_search.nearest_codes(flat, cb, train=False)
    assert idx.tolist() == [7, 7, 7, 7] and torch.equal(z_q, cb[idx])
    ties = torch.zeros(5, 16, device=card)  # every distance equal: index 0, as argmin gives
    assert vq_search.nearest_codes(ties, torch.zeros(9, 16, device=card), train=False)[0].tolist() == [0] * 5


def _same_but_reordered_sums(first, second):
    """Two train-mode calls' (st, idx, codebook, cluster_size, embed_avg):
    the search's outputs and the counts bitwise; the buffers the sums move
    within f32 reordering."""
    assert all(torch.equal(a, b) for a, b in zip(first[:2], second[:2]))
    assert torch.equal(first[3], second[3])
    for a, b in (first[2], second[2]), (first[4], second[4]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_a_train_call_makes_no_host_sync_repeats_and_replays_in_a_graph(card):
    n, k, d = 25_600, 512, 16
    z_e = _z((n // 256, 16, 16, d), torch.bfloat16, device=card)

    def run(q):
        st, idx = q(z_e, True)
        return st, idx, *_buffers(q)

    first = run(_quantizer(k, d, device=card))  # builds the library and sizes the grid
    q = _quantizer(k, d, device=card)
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run(q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same_but_reordered_sums(first, second)
    assert tracing.counters()["vq.fused_calls"] == tracing.counters()["vq.calls"] == 2

    q = _quantizer(k, d, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        run(_quantizer(k, d, device=card))
    torch.cuda.current_stream(card).wait_stream(side)
    launches = vq_search.nearest_codes.launches, vq_search.code_sums.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        captured = run(q)
    assert all(torch.equal(a, b) for a, b in zip(_buffers(q), _buffers(_quantizer(k, d, device=card))))
    graph.replay()
    torch.cuda.synchronize(card)
    _same_but_reordered_sums(first, captured)
    assert (vq_search.nearest_codes.launches, vq_search.code_sums.launches) == (launches[0] + 1, launches[1] + 1)


@pytest.mark.card
def test_the_quantizer_on_the_card_matches_the_cpu(card):
    """A train-mode call of the quantizer, card against CPU, at the
    benchmark's shape: indices equal but near-ties; where none differ, the
    output bitwise and the buffers within f32 reordering."""
    q_cpu, q_card = _quantizer(512, 16, seed=4), _quantizer(512, 16, seed=4, device=card)
    cb0 = q_cpu.codebook.clone()
    z_e = _z((2048, 16, 16, 16), torch.bfloat16, seed=6)
    st_cpu, idx_cpu = q_cpu(z_e, True)
    st, idx = q_card(z_e.to(card), True)
    differ = _assert_near_ties_only(idx.cpu().reshape(-1), idx_cpu.reshape(-1), z_e.reshape(-1, 16).float(), cb0)
    assert differ <= 5
    if differ == 0:
        assert torch.equal(st.cpu(), st_cpu)
        assert torch.equal(q_card.cluster_size.cpu(), q_cpu.cluster_size)
        assert torch.allclose(q_card.embed_avg.cpu(), q_cpu.embed_avg, rtol=1e-5, atol=1e-6)
        assert torch.allclose(q_card.codebook.cpu(), q_cpu.codebook, rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_a_vq_artifact_exported_for_the_card_records_the_operators(card, tmp_path):
    from midi_vae_tpu_torch.interop.aot_export import AOTServingBundle, export_serving_programs
    from midi_vae_tpu_torch.models.registry import build_model

    model = build_model("VQVAE", device="cpu", seed=3, in_channels=1, latent_dim=4, input_dim=32,
                        hidden_dims=(8, 16), codebook_size=16).to(card).eval()
    export_serving_programs(model, str(tmp_path), image_size=32, channels=1, platforms=["cuda"])
    program = torch.export.load(str(tmp_path / "cuda" / "decode.pt2"))
    targets = {str(node.target) for node in program.graph.nodes if node.op == "call_function"}
    assert "midi_vae_tpu_torch.vq_nearest_codes.default" in targets, targets
    assert not any("argmin" in t for t in targets), targets
    bundle = AOTServingBundle(str(tmp_path), device=card)
    z = torch.randn(5, model.flat_latent_dim, generator=torch.Generator().manual_seed(7)).to(card)
    launches = vq_search.nearest_codes.launches
    with torch.no_grad():
        assert torch.equal(bundle.decode(z), model.decode(z))
        x = torch.rand(3, 32, 32, 1, generator=torch.Generator().manual_seed(8)).to(card)
        assert torch.equal(bundle.reconstruct(x), model.decode(model.encode(x).mu))
    assert vq_search.nearest_codes.launches == launches + 4
    assert math.isfinite(float(bundle.decode(z).sum()))
