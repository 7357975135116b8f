"""The roofline count against a count by hand at one shape."""
import pytest

from portbench import roofline


@pytest.mark.parametrize("n, want", [(128, 512 + 4 + 24 + 8),
                                     (256, 1024 + 4 + 24 + 8)])
def test_row_bytes_by_hand(n, want):
    # n f32 samples, a norm, words of 8 + 16 one-byte symbols, two f32
    # residuals.
    assert roofline.row_bytes(n, (8, 16)) == want


def test_window_work_by_hand():
    B, n, levels = 1 << 22, 256, (8, 16)
    buckets = [32, 32, 16]
    nbytes, flops = roofline.window_work(B, n, levels, buckets,
                                         answers=1000)
    assert nbytes == 3 * B * 1060 + 80 * 1060 + 1000 * 8
    assert flops == 3 * 80 * B


def test_bound_takes_the_larger_time():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    t, which = roofline.bound_s(3.35e12, 1.0, peaks)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = roofline.bound_s(1.0, 67e12 * 2, peaks)
    assert which == "flops" and t == pytest.approx(2.0)
    with pytest.raises(KeyError):
        roofline.peaks_for("cpu")


def test_kernel_names_are_shortened():
    from portbench import tracelib
    assert tracelib.short_name(
        "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)") == \
        "at::native::reduce_kernel"
    assert tracelib.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"
