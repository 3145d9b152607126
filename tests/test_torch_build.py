"""Building the kernels, on the CPU: what happens without compiling.

A library already built (by an earlier process) is not rebuilt, and its
compiler report, saved beside it, is read back, so ``chip_smoke.py`` can
record ``ptxas``'s registers and spills in any process.
"""
from repro_torch.kernels import _build


def test_a_built_library_keeps_its_compiler_report(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib = _build.library_path("ssd_scan")
    assert lib.parent == tmp_path
    lib.write_bytes(b"")
    report = "ptxas info    : Used 151 registers\n"
    lib.with_suffix(".log").write_text(report)
    kernels = _build._Builder()
    monkeypatch.setattr(_build, "nvcc_path", lambda: 1 / 0)  # never called
    assert kernels.build(["ssd_scan"]) == {"ssd_scan": lib}
    assert kernels.logs["ssd_scan"] == report
