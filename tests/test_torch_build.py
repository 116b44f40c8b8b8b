"""The port's first-use build (seaweedfs_tpu_torch/ops/_build.py) names
each library by a hash of what goes into it, so an edited source or an
edited shared header (`csrc/*.cuh`) loads a fresh build and never a stale
one.  No compiler runs here: the compilers are stubbed to fixed names and
only the library paths are compared."""

import os
import shutil

import pytest

from seaweedfs_tpu_torch.ops import _build

CUDA_SOURCES = [n for n, src in _build.SOURCES.items() if src.endswith(".cu")]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", str(copy))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.shutil, "which", lambda tool: tool)   # g++
    return copy


def _append(path, text: bytes) -> bytes:
    old = path.read_bytes()
    path.write_bytes(old + text)
    return old


def test_cuda_sources_share_the_bitslice_header():
    for name in CUDA_SOURCES:
        with open(os.path.join(_build.CSRC, _build.SOURCES[name])) as f:
            assert '#include "bitslice.cuh"' in f.read(), name


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_library_name_follows_the_shared_header(csrc, name):
    before = _build._target(name)[0]
    assert _build._target(name)[0] == before      # stable when nothing moves
    old = _append(csrc / "bitslice.cuh", b"// edited\n")
    edited = _build._target(name)[0]
    assert edited != before
    (csrc / "bitslice.cuh").write_bytes(old)
    assert _build._target(name)[0] == before


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_library_name_follows_a_new_header(csrc, name):
    before = _build._target(name)[0]
    (csrc / "extra.cuh").write_bytes(b"#pragma once\n")
    assert _build._target(name)[0] != before


@pytest.mark.parametrize("name", list(_build.SOURCES))
def test_library_name_follows_its_source(csrc, name):
    before = _build._target(name)[0]
    _append(csrc / _build.SOURCES[name], b"\n")
    assert _build._target(name)[0] != before


def test_host_source_ignores_cuda_headers(csrc):
    before = _build._target("crc32c")[0]
    _append(csrc / "bitslice.cuh", b"// edited\n")
    assert _build._target("crc32c")[0] == before


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__a749e_13_clay_fused_cu_0c33d14518clay_encode_kernelILi4EEEvPKhS2_Phiiiixxi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__a749e_13_clay_fused_cu_0c33d14518clay_encode_kernelILi4EEEvPKhS2_Phiiiixxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, 124 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__b1608a4_13_gf2_matmul_cu_3faeb8be17gf2_matmul_kernelILi1EEEvPKhiiS2_Phxxi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__b1608a4_13_gf2_matmul_cu_3faeb8be17gf2_matmul_kernelILi1EEEvPKhiiS2_Phxxi
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function 'plain_entry' for 'sm_90a'
ptxas info    : Function properties for plain_entry
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_chip_smoke_reads_the_ptxas_report():
    """chip_smoke.py prints each kernel's registers and spills from the
    build log; template kernels are named `name<N>`."""
    import chip_smoke
    assert chip_smoke.ptxas_report(PTXAS_LOG) == {
        "clay_encode_kernel<4>": {"stack": 0, "spill_stores": 0,
                                  "spill_loads": 0, "registers": 90},
        "gf2_matmul_kernel<1>": {"stack": 8, "spill_stores": 8,
                                 "spill_loads": 8, "registers": 48},
        "plain_entry": {"stack": 8, "spill_stores": 4, "spill_loads": 4,
                        "registers": 255}}
    assert chip_smoke.ptxas_report("") == {}
