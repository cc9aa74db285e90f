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


def test_every_kernel_source_builds_under_its_own_name():
    """K1/K2, K3 and K4 each build into a library named after their own
    source, all into the one build directory (chip_smoke.py builds them in
    one ``build_all``), and an edit of K4's source renames its library."""
    from uda_clr_tpu_torch.ops import domain_norm, dropout, mask_head

    libraries = (mask_head.LIBRARY, dropout.LIBRARY, domain_norm.LIBRARY)
    paths = [lib.so_path() for lib in libraries]
    assert len(set(paths)) == 3 and all(p.parent == cuda_build.BUILD_DIR for p in paths)
    assert paths[2].name.startswith("libuda_domain_norm_")
    assert domain_norm.LIBRARY.source == cuda_build.CSRC / "domain_norm.cu"


def test_k4_library_name_follows_its_source(tmp_path):
    copy = tmp_path / "domain_norm.cu"
    source = (cuda_build.CSRC / "domain_norm.cu").read_bytes()
    copy.write_bytes(source)
    here = cuda_build.KernelLibrary("domain_norm.cu", {}).so_path()
    assert cuda_build.KernelLibrary(copy, {}).so_path() == here
    copy.write_bytes(source + b"\n// an edit\n")
    assert cuda_build.KernelLibrary(copy, {}).so_path() != here
