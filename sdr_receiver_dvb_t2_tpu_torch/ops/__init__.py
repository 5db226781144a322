"""The receiver's operators; K1-K8 are its hand-written CUDA kernels."""


def kernel_wrappers() -> dict:
    """{name: the launch-counting wrapper} of K1-K8: each wrapper adds one
    to its `launches` where it launches its kernel."""
    from . import fft_stage1, frontend_device, llr_tail
    from . import ldpc_layered as ll
    return {"K1": ll.ldpc_layered_cuda, "K2": ll.ldpc_layered_adaptive_cuda,
            "K3": ll.ldpc_layered_vmem_cuda, "K4": ll.ldpc_layered_hbm_cuda,
            "K5": ll.ldpc_layered_fused_io_cuda,
            "K6": fft_stage1.fft_stage1_cuda, "K7": llr_tail.llr_tail_cuda,
            "K8": frontend_device.frontend_correct_cuda}
