"""``kernels._build.lib_path`` on a copy of ``csrc``: a library's name
follows its source, every shared header ``csrc/*.cuh`` and the flags, so
an edited header rebuilds the kernels that include it.  Needs no nvcc:
only the names are computed."""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _paths():
    return {n: _build.lib_path(n) for n in _build.SOURCES}


def test_the_sources_share_a_header(csrc):
    assert (csrc / "hopper.cuh").exists()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()


def test_same_files_same_paths(csrc):
    assert _paths() == _paths()


@pytest.mark.parametrize("edit", ["edit the header", "add a header"])
def test_header_change_renames_every_library(csrc, edit):
    before = _paths()
    if edit == "edit the header":
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(before[n] != after[n] for n in _build.SOURCES)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_source_edit_renames_only_its_library(csrc):
    before = _paths()
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert [n for n in _build.SOURCES if before[n] != after[n]] == [
        "flash_attention"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_\
attention_cu_0d6f9d4a16flash_fwd_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv\
_bfloat16Pfiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_\
attention_cu_0d6f9d4a16flash_fwd_kernelILi256EEEv14CUtensorMap_stS1_S1_P13__nv\
_bfloat16Pfiiiifi
    600 bytes stack frame, 1096 bytes spill stores, 968 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 600 bytes cumulative \
stack size
ptxas info    : Compiling entry function '_Z13gather_kernelPKfPKiPfii' for \
'sm_90a'
ptxas info    : Function properties for _Z13gather_kernelPKfPKiPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__798d4582_18_neighbor_\
sample_cu_e0931d6529neighbor_sample_cached_kernelEPKiS1_S1_llS1_S1_Pili' for \
'sm_90a'
ptxas info    : Used 28 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__0e5f9a1c_17_ssd_chunk\
_scan_cu_7e0a1b2c22ssd_chunk_state_kernelILi8ELi4EEEvPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
"""


def test_ptxas_report_names_each_kernel_with_registers_and_spills():
    assert _build.ptxas_report({"flash_attention": PTXAS_LOG}) == [
        {"source": "flash_attention", "kernel": "flash_fwd_kernel<256>",
         "registers": 168, "spill_stores": 1096, "spill_loads": 968},
        {"source": "flash_attention", "kernel": "gather_kernel",
         "registers": 30, "spill_stores": 0, "spill_loads": 0},
        {"source": "flash_attention",
         "kernel": "neighbor_sample_cached_kernel", "registers": 28,
         "spill_stores": None, "spill_loads": None},
        {"source": "flash_attention", "kernel": "ssd_chunk_state_kernel<8, 4>",
         "registers": 110, "spill_stores": 0, "spill_loads": 0}]
    assert _build.ptxas_report({}) == []
