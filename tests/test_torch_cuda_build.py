"""The port's kernel builder (uda_clr_tpu_torch/ops/cuda_build.py) names a
library after everything nvcc reads, so two builds of one source against
different headers never share a file. Runs on the CPU: nothing is built."""

from uda_clr_tpu_torch.ops import cuda_build


def test_library_name_covers_the_headers_beside_the_source(tmp_path):
    copy = tmp_path / "mask_head.cu"
    copy.write_bytes((cuda_build.CSRC / "mask_head.cu").read_bytes())
    here = cuda_build.KernelLibrary("mask_head.cu", {}).so_path()
    # the same bytes with the same headers: the same library
    assert cuda_build.KernelLibrary(copy, {}).so_path() == here
    # a header beside the copy comes first on nvcc's include path
    (tmp_path / "philox.cuh").write_text("// another Philox\n")
    assert cuda_build.KernelLibrary(copy, {}).so_path() != here
    assert here.parent == cuda_build.BUILD_DIR and here.name.startswith("libuda_mask_head_")
