"""Backend choice, compile-cache location and the native host library
build (knoxdb_tpu/config.py, knoxdb_tpu/utils/native.py)."""

from pathlib import Path

import pytest

from knoxdb_tpu import config


@pytest.mark.parametrize("platform,want", [("cpu", "xla"), ("gpu", "triton"),
                                           ("rocm", "xla"), ("METAL", "xla")])
def test_kernel_family_by_platform(platform, want):
    assert config.kernel_family(platform) == want


def test_kernel_family_override_and_default(monkeypatch):
    # this process runs on the CPU backend: no kernel family, and
    # interpret mode is never a choice
    assert config.kernel_family() == "xla"
    assert {config.kernel_family(p) for p in ("cpu", "gpu", "rocm")} \
        <= {"xla", "triton"}
    # the environment holds no override: a scanner takes the platform's
    # family as its default, and its `kernels` attribute is the override
    from knoxdb_tpu.exec import scan as SC
    monkeypatch.setenv("KNOX_KERNELS", "xla")
    monkeypatch.setattr(config.jax, "devices",
                        lambda: [type("Dev", (), {"platform": "gpu"})()])
    sc = SC.SegmentScanner(None)
    assert sc.kernels == "triton"
    monkeypatch.setattr(config.jax, "devices",
                        lambda: [type("Dev", (), {"platform": "cpu"})()])
    assert SC.SegmentScanner(None).kernels == "xla"


def test_compile_cache_dir_rule():
    assert config.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) \
        is None
    d = Path(config.compile_cache_dir({}))
    assert d == Path(config.__file__).resolve().parents[1] / ".jax_cache"
    assert config.compile_cache_dir({}) == str(d)      # fixed, not per-run


def test_native_library_built_from_source(monkeypatch, tmp_path):
    from knoxdb_tpu.utils import native as NT
    if not NT.available():
        pytest.skip("no C++ toolchain: numpy fallbacks in use")
    so = NT.library_path()
    assert Path(NT.lib._name) == so and so.exists()
    # the build name follows the source: an edited source never loads
    # the old binary
    src = tmp_path / "knox_native.cc"
    src.write_text(NT._SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(NT, "_SRC", src)
    assert NT.library_path() != so
