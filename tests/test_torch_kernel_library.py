"""The kernel library's cache key: the built library's file name carries a
hash of every CUDA source and header it is built from, so a change to any
of them builds a new library at the next launch. Runs on the CPU (the name
is computed without building)."""

import shutil

from kubernetes_tpu_torch.ops import wave_kernel


def test_library_name_covers_every_source_and_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(wave_kernel.CSRC, csrc)
    lib = wave_kernel.KernelLibrary(
        sources=[csrc / s.name for s in wave_kernel.SOURCES],
        build_dir=tmp_path / "build")
    names = {p.name for p in lib.inputs()}
    assert {"wave_solve.cu", "wave_eval.cu", "score.cuh"} <= names
    seen = {lib.library_path()}
    for name in ("wave_solve.cu", "wave_eval.cu", "score.cuh"):
        with open(csrc / name, "a") as f:
            f.write("\n// changed\n")
        path = lib.library_path()
        assert path not in seen, name
        assert path.parent == tmp_path / "build"
        seen.add(path)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert lib.library_path() not in seen          # a new header counts
    # The package's own library is keyed the same way.
    assert wave_kernel.LIBRARY.library_path().name.startswith(
        "libktpu_kernels_")
