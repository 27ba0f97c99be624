"""The arithmetic of the timeline and of the rate, on made-up events."""

import pytest

from bench_cuda import run, trace


def _reader(name):
    return run.load_file(f"bench_cuda/metrics/{name}.py", "m_" + name.replace(".", "_")).read


def _timeline():
    # a 10 ms stretch: kernels overlap at 2-3 ms, the device idles 4-6 ms and 9-10 ms
    tl = trace.Timeline(window=(0.0, 0.010))
    tl.kernels = [("conv", 0.000, 0.003), ("bn", 0.002, 0.004), ("_bce_partial_kernel", 0.006, 0.007),
                  ("_sum_partials_kernel", 0.007, 0.0071), ("_bce_grad_kernel", 0.0071, 0.009)]
    tl.device_ops = list(tl.kernels)
    tl.host = [("train_step", 0.0, 0.0095), ("aten::item", 0.004, 0.0059), ("cudaStreamSynchronize", 0.0091, 0.0099)]
    return tl


def test_union_counts_overlap_once_and_clips():
    assert trace.union_seconds([(0, 3), (2, 4), (6, 7)], 0, 10) == pytest.approx(5)
    assert trace.union_seconds([(-5, 1), (9, 20)], 0, 10) == pytest.approx(2)
    assert trace.union_seconds([], 0, 10) == 0


def test_idle_gaps_and_share():
    tl = _timeline()
    gaps = trace.idle_gaps([(s, e) for _, s, e in tl.device_ops], *tl.window)
    assert gaps == [pytest.approx((0.004, 0.006)), pytest.approx((0.009, 0.010))]
    assert tl.busy_s() == pytest.approx(0.007)
    assert _reader("device_idle_share.train")({"timeline": tl}) == pytest.approx(30.0)


def test_breakdown_labels_gaps_by_the_host():
    bd = trace.breakdown(_timeline())
    assert bd["device_ops"][0] == ["conv", pytest.approx(0.003)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {"aten::item": pytest.approx(0.002),
                                                         "cudaStreamSynchronize": pytest.approx(0.001)}


def test_breakdown_takes_device_time_and_idle_labels_from_their_own_stretches():
    device = trace.Timeline(window=(0.0, 0.004), device_ops=[("conv", 0.0, 0.002), ("bn", 0.002, 0.0035)])
    bd = trace.breakdown(device, _timeline())
    assert [k for k, _ in bd["device_ops"]] == ["conv", "bn"] and bd["device_ops"][0][1] == pytest.approx(0.002)
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {"aten::item": pytest.approx(0.002),
                                                         "cudaStreamSynchronize": pytest.approx(0.001)}


def test_chrome_trace_parse():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": 100.0, "dur": 1000.0, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 200.0, "dur": 50.0, "pid": 0, "tid": 7},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300.0, "dur": 10.0, "pid": 0, "tid": 8},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "x", "ts": 100.0, "dur": 900.0, "pid": 0, "tid": 9},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150.0, "dur": 20.0, "pid": 1, "tid": 2}]
    tl = trace.parse_chrome_trace(ev)
    assert tl.window == pytest.approx((100e-6, 1100e-6))
    assert [k[0] for k in tl.kernels] == ["k"] and len(tl.device_ops) == 2
    assert [h[0] for h in tl.host] == [trace.STRETCH, "aten::add"]
    assert tl.busy_s() == pytest.approx(60e-6)


def test_device_only_trace_takes_its_stretch_from_the_marker_kernels():
    """Without an annotation (no host activity recorded) the stretch runs
    from the first marker kernel's start to the last one's end, and the
    markers are not device work."""
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [{"ph": "X", "cat": "kernel", "name": mark, "ts": 100.0, "dur": 2.0, "pid": 0, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "conv", "ts": 110.0, "dur": 500.0, "pid": 0, "tid": 7},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 700.0, "dur": 100.0, "pid": 0, "tid": 7},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 90.0, "dur": 5.0, "pid": 1, "tid": 2},
          {"ph": "X", "cat": "kernel", "name": mark, "ts": 998.0, "dur": 2.0, "pid": 0, "tid": 7}]
    tl = trace.parse_chrome_trace(ev)
    assert tl.window == pytest.approx((100e-6, 1000e-6))
    assert [k[0] for k in tl.kernels] == ["conv"] and len(tl.device_ops) == 2 and tl.host == []
    assert _reader("device_idle_share.train")({"timeline": tl}) == pytest.approx(100 * (1 - 600 / 900))
    with pytest.raises(RuntimeError):
        trace.parse_chrome_trace(ev[1:3])


def test_launches_mfu_and_rooflines():
    tl = _timeline()
    traced = {"timeline": tl, "stretch_steps": 1, "window": {"seconds": 2.0, "steps": 10},
              "flops_per_step": 989e12 * 0.01, "peak_flops": 989e12,
              "kernel_calls": {"K1": [(1000, 2, 4)], "K2": [(1000, 2, 4)]}}
    assert _reader("launches_per_step.train")(traced) == 5
    assert _reader("mfu.train")(traced) == pytest.approx(0.01 * 10 / 2.0 * 100)
    k1 = (1000 * 6 + 4) / 3.35e12 / 0.0011 * 100
    assert _reader("k1_roofline")(traced) == pytest.approx(k1)
    assert _reader("k2_roofline")(traced) == pytest.approx((1000 * 8 + 4) / 3.35e12 / 0.0019 * 100)
    # no call in the stretch: nothing to read, never 0
    assert _reader("k1_roofline")({**traced, "kernel_calls": {}}) is None
    tl.kernels = [k for k in tl.kernels if "bce" not in k[0]]
    assert _reader("k2_roofline")(traced) is None


def test_a_stall_moves_the_rate():
    # a training window: the rate is all the samples over all the window's
    # seconds, so a 0.3 s stall among 500 steps of 20 ms shows in full
    steps = [0.02] * 500
    stalled_steps = steps[:250] + [0.32] + steps[251:]
    rate, rate_stalled = 500 * 2048 / sum(steps), 500 * 2048 / sum(stalled_steps)
    assert rate_stalled == pytest.approx(rate * 10.0 / 10.3)
    # a median of per-chunk rates would not see it
    chunks = [sum(stalled_steps[i:i + 50]) for i in range(0, 500, 50)]
    assert sorted(chunks)[5] == pytest.approx(1.0)
