"""Reading a profiled slice, on a hand-written Chrome trace: one call with
benchmark spans, nested program spans, host ops, runtime calls with
correlation ids, three kernels and a device-to-host copy.

Times in us.  The call is [0, 100]; `entropy` [5, 60] holds
`vcf.rans.encode` [6, 41] (with `vcf.rans.layout` [8, 20] and, inside it,
`vcf.dct.layout` [9.5, 11]) and `vcf.rans.assemble` [41.5, 58] (with
`vcf.rans.sync` [45, 57]); `transform` [62, 95].  Device items: a copy
kernel [12, 22] launched at 10, K1 [27, 40] launched at 25, the DtoH
copy [48, 52] launched at 47, B4 [70, 80] launched at 65.  Idle gaps:
[0, 12], [22, 27], [40, 48], [52, 70] and the tail [80, 100]."""

import pytest

from portbench.core import program, trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "portbench.call", 0, 100),
    _x("user_annotation", "portbench.entropy", 5, 55),
    _x("user_annotation", "portbench.transform", 62, 33),
    _x("user_annotation", "vcf.rans.encode", 6, 35),
    _x("user_annotation", "vcf.rans.layout", 8, 12),
    _x("user_annotation", "vcf.dct.layout", 9.5, 1.5),
    _x("user_annotation", "vcf.rans.assemble", 41.5, 16.5),
    _x("user_annotation", "vcf.rans.sync", 45, 12),
    # the GPU's projection of a range is not a host span
    _x("gpu_user_annotation", "vcf.rans.sync", 48, 4),
    _x("cpu_op", "aten::reshape", 9, 10),
    _x("cpu_op", "aten::_to_copy", 46, 10),
    _x("cpu_op", "aten::copy_", 64, 6),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 47, 9, correlation=3),
    _x("cuda_runtime", "cudaLaunchKernel", 65, 1, correlation=4),
    _x("kernel", "elementwise_kernel", 12, 10, correlation=1),
    _x("kernel", "rans_encode_kernel", 27, 13, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 48, 4,
       correlation=3),
    _x("kernel", "dct_inverse_kernel", 70, 10, correlation=4),
]


@pytest.fixture
def half():
    return trace.HalfTrace(EVENTS, calls=1)


def test_the_slice_reads_as_before(half):
    """The numbers every existing per-layer metric and the breakdown read
    from this trace (frozen: a later change to trace.py keeps them)."""
    assert (half.t0, half.t1, half.calls, half.attributed) == (0, 100, 1, 4)
    assert half.window_s == pytest.approx(100e-6)
    assert half.busy_s == pytest.approx(37e-6)
    assert half.span_s("entropy") == pytest.approx(27e-6)
    assert half.span_s("entropy", kernel="rans") == pytest.approx(13e-6)
    assert half.span_s("transform") == pytest.approx(10e-6)
    assert half.span_s("gop_loop") == 0
    assert half.has_span("entropy") and not half.has_span("gop_loop")
    assert sorted(half.span_names()) == ["entropy", "transform"]
    assert half.spans_at(10) == ["entropy"]
    assert dict(half.device_ops()) == pytest.approx({
        "elementwise_kernel": 10e-6, "rans_encode_kernel": 13e-6,
        "Memcpy DtoH (Device -> Pageable)": 4e-6,
        "dct_inverse_kernel": 10e-6})
    assert dict(half.idle_gaps()) == pytest.approx({
        "entropy: aten::reshape / cudaLaunchKernel": 12e-6,
        "entropy: cudaLaunchKernel": 5e-6,
        "entropy: aten::_to_copy / cudaMemcpyAsync": 8e-6,
        "transform: aten::copy_ / cudaLaunchKernel": 18e-6,
        "end of call": 20e-6})


def test_program_spans_and_kinds(half):
    spans = program.ProgramSpans(EVENTS, half)
    assert len(spans.spans) == 5
    assert spans.kinds() == ["assemble", "encode", "layout", "sync"]
    assert spans.open_at(10) == ["vcf.rans.encode", "vcf.rans.layout",
                                 "vcf.dct.layout"]
    assert spans.open_at(41.2) == []
    assert spans.kind_open("sync", 52) and not spans.kind_open("sync", 58)


def test_program_s_counts_an_item_once(half):
    spans = program.ProgramSpans(EVENTS, half)
    # launched at 10 inside two `.layout` spans: counted once
    assert spans.program_s("layout") == pytest.approx(10e-6)
    assert spans.program_s("encode") == pytest.approx(23e-6)
    assert spans.program_s("sync") == pytest.approx(4e-6)
    assert spans.program_s("assemble") == pytest.approx(4e-6)
    assert spans.program_s("luma") == 0
    assert dict(spans.by_span_s()) == pytest.approx({
        "vcf.dct.layout": 10e-6, "vcf.rans.encode": 13e-6,
        "vcf.rans.sync": 4e-6})


def test_idle_in_s_charges_a_gap_to_the_spans_open_where_it_opens(half):
    spans = program.ProgramSpans(EVENTS, half)
    # the copy ends at 52 inside `vcf.rans.sync`: the gap to 70 is the wait's
    assert spans.idle_in_s("sync") == pytest.approx(18e-6)
    assert spans.idle_in_s("assemble") == pytest.approx(18e-6)
    # gaps opening at 22 and 40, both inside `vcf.rans.encode`
    assert spans.idle_in_s("encode") == pytest.approx(13e-6)
    assert spans.idle_in_s("layout") == 0


def test_idle_labels_carry_the_innermost_program_span(half):
    gaps = program.ProgramSpans(EVENTS, half).idle_gaps()
    assert dict(gaps) == pytest.approx({
        "entropy: vcf.dct.layout: aten::reshape / cudaLaunchKernel": 12e-6,
        "entropy: vcf.rans.encode: cudaLaunchKernel": 5e-6,
        "entropy: vcf.rans.sync: aten::_to_copy / cudaMemcpyAsync": 8e-6,
        "transform: aten::copy_ / cudaLaunchKernel": 18e-6,
        "end of call": 20e-6})
    assert sum(gaps.values()) == pytest.approx(half.window_s - half.busy_s)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    from portbench.tests import _small
    return _small.checkout(tmp_path_factory.mktemp("program_trace"))


#: layout bytes a call on the CPU, in symbols of the clip: III encodes
#: copy the lanes out once and decodes copy them back twice (regrouped by
#: subband, then the tiles joined); IPP stacks its u8 planes and f32
#: reconstruction (2 x 5) and copies the lanes once, and its decode
#: stacks the f32 reconstruction (2 x 4) after the two lane copies
LAYOUT_SYMBOLS = {"iii_wire_32f": (2, 4), "iii_device_32f": (2, 4),
                  "ipp_grid_80f": (12, 12)}


@pytest.mark.parametrize("cell", sorted(LAYOUT_SYMBOLS))
def test_program_trace_counts_each_call_of_a_small_run(small_root, cell):
    import torch

    from portbench import program_trace

    r = program_trace.run(cell, 2 ** 31 + 7, 0.1, torch.device("cpu"),
                          small_root)
    assert r["correct"]
    frames = 20 if cell.startswith("ipp") else 4
    symbols = frames * 3 * 64 * 128
    for name, k in zip(("encode", "decode"), LAYOUT_SYMBOLS[cell]):
        half = r[name]
        assert half["counts"] == {"layout_bytes": k * symbols,
                                  "host_syncs": 0}, (name, half["counts"])
        # the CPU launches no device items
        assert half["program_ms"]["layout"] == 0
    if cell.startswith("ipp"):
        assert {"luma", "pixels", "search", "compensate"} <= set(
            r["encode"]["program_ms"])
        assert r["encode"]["gop_loop_rest_ms"] == 0
