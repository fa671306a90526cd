"""The kernel build's cache key: a library is named by a hash of its
source, the ``csrc/`` headers it includes (and theirs) and the flags, so
an edited header rebuilds every kernel that includes it. No ``nvcc`` is
needed: the hash is computed before any build."""


def _tree(tmp_path):
    (tmp_path / "a.cu").write_text('#include "rows.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cuda_runtime.h>\nint b;\n")
    (tmp_path / "rows.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")


def test_digest_follows_included_headers(tmp_path, monkeypatch):
    from kinetica_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    _tree(tmp_path)
    a0, b0 = cuda_build.source_digest("a"), cuda_build.source_digest("b")
    assert a0 == cuda_build.source_digest("a")          # stable
    (tmp_path / "inner.cuh").write_text("#pragma once\nint inner2;\n")
    a1 = cuda_build.source_digest("a")
    assert a1 != a0                                     # nested header
    (tmp_path / "rows.cuh").write_text('#pragma once\n#include "inner.cuh"\n//\n')
    assert cuda_build.source_digest("a") != a1          # direct header
    (tmp_path / "other.cuh").write_text("int other2;\n")
    assert cuda_build.source_digest("b") == b0          # not included


def test_digest_of_the_shipped_kernels():
    """Every kernel source hashes (its headers exist); the two kernels that
    share the species contraction hash its header."""
    from kinetica_tpu_torch.ops import cuda_build
    names = ("fused_rhs", "gj_inverse", "dd_contract", "newton_solve",
             "grid_probe")
    digests = {n: cuda_build.source_digest(n) for n in names}
    assert len(set(digests.values())) == len(names)
    for n in ("fused_rhs", "dd_contract"):
        assert '#include "csr_rows.cuh"' in (cuda_build.CSRC
                                            / f"{n}.cu").read_text()
