"""The trace reader's arithmetic and its kernel names."""

from pathlib import Path

import pytest

import tcgnn_tpu_torch
from benchmark import trace

PACKAGE = Path(tcgnn_tpu_torch.__file__).parent


def test_the_port_kernels_are_found_by_name():
    kernels = trace.port_kernels(PACKAGE)
    assert {"spmm_dense_kernel", "sfused_kernel", "sfused_bwd_kernel", "sddmm_edge_kernel",
            "spmm_bd_kernel", "bd_sfused_kernel", "bd_sfused_bwd_kernel", "spmm_csr_kernel",
            "sddmm_csr_kernel"} <= kernels


def test_a_new_kernel_is_found_without_an_edit(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text(
        "template <int N>\n__global__ void __launch_bounds__(256)\nnew_kernel(float* x) {}\n"
        "__global__ void other(int n) {}\n")
    (tmp_path / "t.py").write_text("import triton\n\n@triton.jit\ndef tri_kernel(x):\n    pass\n")
    assert trace.port_kernels(tmp_path) == {"new_kernel", "other", "tri_kernel"}


@pytest.mark.parametrize("name, ours", [
    ("void (anonymous namespace)::spmm_csr_kernel<float, true, 8>(float const*, long)", True),
    ("void (anonymous namespace)::spmm_dense_kernel<float, signed char, float, false>(int)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)",
     False),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3", False),
    ("memset32", False),
])
def test_is_port_kernel(name, ours):
    assert trace.is_port_kernel(name, trace.port_kernels(PACKAGE)) is ours


def test_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (30, 31), (30, 40)]
    assert trace.union_us(spans) == 12 + 5 + 10
    assert trace._gaps(spans) == [(12, 20), (25, 30)]


def test_host_at_takes_the_innermost_operation():
    host = [(0, 100, "outer"), (10, 50, "inner"), (60, 70, "later")]
    assert trace._host_at(20, host) == "inner"
    assert trace._host_at(55, host) == "outer"
    assert trace._host_at(150, host) == "no traced host operation"


def test_idle_share():
    t = trace.Trace(epochs=2, window_s=2.0, busy_s=1.5, kernel_s=1.0, other_s=0.5,
                    device_ops=[], idle_gaps=[])
    assert t.idle_share == pytest.approx(0.25)
