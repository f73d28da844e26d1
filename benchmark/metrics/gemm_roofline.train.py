"""The matrix products' share of their roofline: the least time the card
could take for the step's products (each at the larger of its FLOPs at the
float32 peak outside the tensor cores and its bytes at the memory
bandwidth; ``flops.py``, from the published widths) over the device time
of the matrix-product kernels. A kernel is a matrix product's where its
name says so or PyTorch's matrix-product operator launched it."""

NAME_KEYS = ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma", "ampere", "nvjet", "splitk")
OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm", "aten::mv",
       "aten::addmv", "aten::dot", "aten::matmul", "aten::linear", "aten::einsum")


def read(sl):
    return sl.roofline_pct(NAME_KEYS, OPS)
