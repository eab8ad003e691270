"""Bytes, ops and least times of the kernel launches, on hand-worked
launches, and the wrappers that count them."""
import pytest
import torch

from nbbench import kernel_work as kw

MAX = kw.KEY_MAX


def test_live_pairs_and_bit_lengths_on_the_device_side():
    assert int(kw.live_pairs(torch.tensor([1, 3, MAX, MAX]),
                             torch.tensor([2, MAX]))) == 3
    assert int(kw.live_pairs(torch.tensor([[1, MAX], [4, 5]]),
                             torch.tensor([[MAX, MAX], [6, MAX]]))) == 4
    counts = torch.tensor([0, 1, 3, 4, 7, 21504], dtype=torch.int32)
    want = sum(int(c).bit_length() for c in counts)
    assert int(kw.bit_lengths(counts)) == want == 0 + 1 + 2 + 3 + 3 + 15


def test_work_of_hand_worked_launches():
    nbytes, nops = kw.merge_work(3)              # 3 live pairs
    assert nbytes == 72                          # 12 B in + 12 B out each
    assert nops == pytest.approx(6 * (3 / 512 * 64 + 3 / 4 * 11 + 3))
    # counts 0, 1, 3, 7: ceil(log2(c + 1)) + 1 = 1, 2, 3, 4 keys read
    assert kw.search_work(0 + 1 + 2 + 3, 4) == (8 * 10 + 4 * 29, 60)
    assert kw.bloom_work(10, 3) == (370, 360)
    # one query, 2 candidates of counts 0 and 3 (bit lengths 0 + 2), 4
    # matched (capped) pairs, cap 4: 2 x (1 + 3) keys searched
    nbytes, nops = kw.range_work(2, 4, 1, 2, 4)
    assert nbytes == 8 * 8 + 12 * 4 + 2 * 12 + 16 + 2 * 4 * 12
    assert nops == 6 * 8 + 2 * 4 * 3


def test_peaks_by_card_name():
    assert kw.peaks("NVIDIA H100 80GB HBM3")["hbm_bw"] == 3.35e12
    assert kw.peaks("NVIDIA H100 PCIe")["hbm_bw"] == 2.0e12


def test_wrappers_count_launches_and_restore_the_entry_points():
    from repro_torch.kernels import ops

    plain = ops.merge_sorted
    rates = kw.peaks("H100 SXM")
    a_k = torch.tensor([1, 3], dtype=torch.int64)
    b_k = torch.tensor([2, MAX], dtype=torch.int64)
    v = torch.zeros(2, dtype=torch.int32)
    with kw.KernelWork(ops, rates) as work:
        assert ops.merge_sorted is not plain
        mk, _ = ops.merge_sorted(a_k, v, b_k, v)
        ops.bloom_probe_rows(torch.zeros((1, 128), dtype=torch.int64),
                             torch.zeros(5, dtype=torch.int32),
                             torch.arange(5, dtype=torch.int64), nbits=4096)
    assert ops.merge_sorted is plain
    assert mk[:3].tolist() == [1, 2, 3]
    least = work.least_time_s()
    n, t = least["merge_sorted"]
    assert n == 1 and t == pytest.approx(
        max(72 / rates["hbm_bw"], kw.merge_ops(3) / rates["int_ops"]))
    assert least["bloom_probe_rows"] == (
        1, pytest.approx(max(5 * 37 / rates["hbm_bw"],
                             5 * 36 / rates["int_ops"])))
    assert least["range_scan_rows"] == (0, 0.0)


def test_device_trace_busy_time_names_and_idle_gaps():
    from nbbench import devtrace

    events = [("merge_tile_kernel(long)", 100, 50), ("k2", 120, 100),
              ("merge_tile_kernel(long)", 400, 10), ("spin_kernel", 0, 5),
              ("k3", 600, 20), ("k4", 2000, 5)]
    # host window [0, 1000) ns, device clock 50 ns ahead: device [50, 1050)
    trace = devtrace.DeviceTrace(events, 0, 1000, offset_ns=50)
    assert trace.busy[0].tolist() == [100, 400, 600]
    assert trace.busy[1].tolist() == [220, 410, 620]
    assert trace.busy_s == pytest.approx(150e-9)
    assert trace.kernel_s("merge_tile_kernel") == pytest.approx(60e-9)
    assert trace.by_name()["merge_tile_kernel"] == pytest.approx(60e-9)
    host = devtrace.HostSpans()
    host.add_layer([(200, 400, "_flush_impl")])
    host.add_layer([(0, 1000, "apply")])
    gaps = dict(trace.idle_gaps(host, "loop"))
    # gaps [50,100) [220,400) [410,600) [620,1050): midpoints on the host
    # 25, 260, 455, 785
    assert gaps["_flush_impl"] == pytest.approx(180e-9)
    assert gaps["apply"] == pytest.approx(670e-9)
    assert devtrace.clock_offset(-5, events) == 5
