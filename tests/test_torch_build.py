"""The ptxas report of the kernel build (cylon_tpu_torch._build), on the CPU:
each kernel's registers, spills and static shared memory, read from the
log that ``nvcc -Xptxas -v`` leaves beside a built library."""
from cylon_tpu_torch import _build

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116pack_dest_kernelILb1EEEvPKiS2_Pixxiixx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116pack_dest_kernelILb1EEEvPKiS2_Pixxiixx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114compact_kernelEPKiS1_xPiixxx' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114compact_kernelEPKiS1_xPiixxx
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 136 bytes smem, 408 bytes cmem[0]
"""


def test_resource_usage_reads_ptxas_report(tmp_path, monkeypatch):
    lib = tmp_path / "libshuffle_codec_0123456789abcdef.so"
    monkeypatch.setattr(_build, "_target", lambda name: lib)
    assert _build.resource_usage("shuffle_codec") == {}  # not built here
    lib.with_suffix(".ptxas.txt").write_text(_LOG)
    usage = _build.resource_usage("shuffle_codec")
    assert list(usage) == [
        "_ZN12_GLOBAL__N_116pack_dest_kernelILb1EEEvPKiS2_Pixxiixx",
        "_ZN12_GLOBAL__N_114compact_kernelEPKiS1_xPiixxx",
    ]
    dest, compact = usage.values()
    assert dest == {"registers": 40, "spill_stores": 0, "spill_loads": 0, "smem": 0}
    assert compact == {"registers": 255, "spill_stores": 12, "spill_loads": 16, "smem": 136}

