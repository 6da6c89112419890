"""The CUDA build of horovod_tpu_torch, without nvcc: which sources a
library hashes, that each translation unit compiles in its own nvcc process
(all started before any is waited on) and the objects link into one shared
library, that a failed unit raises and leaves no library, and that the
ctypes signature table matches the C entry points it binds.

The compile itself runs only on the GPU machine (``chip_smoke.py``)."""

import re
import subprocess
from pathlib import Path

import pytest

from horovod_tpu_torch import _build
from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("main.cu", "second.cu", "common.cuh", "notes.txt"):
        (src / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LIBRARIES",
                        {"lib": ("main.cu", "second.cu")})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/fake/nvcc")
    return src


class FakeNvcc:
    """Stands in for subprocess.Popen: records each command, writes the
    file named after -o, and fails the commands that name ``fail``."""

    def __init__(self, fail=()):
        self.commands, self.waited, self.fail = [], [], fail

    def __call__(self, cmd, **kwargs):
        fake = self

        class Proc:
            returncode = None

            def communicate(self):
                fake.waited.append(cmd)
                bad = any(f in " ".join(cmd) for f in fake.fail)
                self.returncode = 1 if bad else 0
                if not bad:
                    Path(cmd[cmd.index("-o") + 1]).write_text("built")
                return ("error: failed\n" if bad else "", None)

        self.commands.append(cmd)
        return Proc()


@pytest.mark.parametrize("edited,changes", [
    ("main.cu", True), ("second.cu", True), ("common.cuh", True),
    ("notes.txt", False)])
def test_library_hash_covers_every_unit_and_header(csrc, edited, changes):
    before = _build.library_path("lib")
    (csrc / edited).write_text("// edited\n")
    assert (_build.library_path("lib") != before) == changes


def test_each_unit_compiles_apart_then_one_link(csrc, monkeypatch):
    nvcc = FakeNvcc()
    monkeypatch.setattr(subprocess, "Popen", nvcc)
    logs = _build.build(["lib"])
    compiles, links = nvcc.commands[:2], nvcc.commands[2:]
    assert [c[-1] for c in compiles] == [str(csrc / "main.cu"),
                                         str(csrc / "second.cu")]
    assert all("-c" in c and "-shared" not in c for c in compiles)
    # both compiles were started before either was waited on
    assert nvcc.waited[:2] == compiles
    assert len(links) == 1 and "-shared" in links[0]
    objects = [c[c.index("-o") + 1] for c in compiles]
    assert links[0][-2:] == objects
    assert _build.library_path("lib").read_text() == "built"
    assert not any(Path(o).exists() for o in objects)
    assert set(logs) == {"main.cu", "second.cu", "lib"}
    assert _build.build(["lib"]) == {}   # current: nothing to do


def test_failed_unit_raises_and_leaves_no_library(csrc, monkeypatch):
    nvcc = FakeNvcc(fail=("second.cu",))
    monkeypatch.setattr(subprocess, "Popen", nvcc)
    with pytest.raises(RuntimeError, match="second.cu"):
        _build.build(["lib"])
    assert not any("-shared" in c for c in nvcc.commands)
    assert not _build.library_path("lib").exists()
    assert list(_build.BUILD_DIR.iterdir()) == []


def _c_parameters(source, name):
    match = re.search(rf"\bint {name}\(([^)]*)\)", source)
    assert match, f"{name} is not defined in the entry-point unit"
    return [p for p in match.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("name", sorted(tfa._SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    """Every entry point the wrapper binds is defined in the library's first
    unit with as many parameters as its argtypes, each pointer where the
    wrapper passes c_void_p."""
    units = _build.sources("flash_attention")
    assert all(u.exists() for u in units)
    params = _c_parameters(units[0].read_text(), name)
    argtypes = tfa._SIGNATURES[name]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is tfa._P), (name, param)


@pytest.mark.parametrize("cuda_core,unit,macro", [
    ("flash_fwd_fp32_kernel", "flash_fwd_sm90.cu", "HVD_FWD_SM90"),
    ("flash_bwd_dkv_fp32_kernel", "flash_dkv_sm90.cu", "HVD_DKV_SM90"),
    ("flash_bwd_dq_fp32_kernel", "flash_dq_sm90.cu", "HVD_DQ_SM90")])
def test_sixteen_bit_forward_and_dkv_reach_only_the_wgmma_kernels(
        cuda_core, unit, macro):
    """Each kernel's CUDA-core version (forward, dK/dV, dQ) takes float32
    only, and its 16-bit instances are the wgmma ones of a unit that the
    library builds, in bf16 and fp16, at head dims 64 and 128, in all three
    dropout modes."""
    units = {u.name: u.read_text()
             for u in _build.sources("flash_attention")}
    main = units["flash_attention.cu"]
    head = main[main.index(f"{cuda_core}("):]
    params = head[:head.index(")")]
    assert "const float* __restrict__ q" in params
    assert "const __" not in params
    assert "template <int D, int MODE>" in main[:main.index(
        f"{cuda_core}(")].rsplit("// ---", 1)[-1]
    assert unit in units
    text = units[unit] + _build.CSRC.joinpath("flash_sm90.cuh").read_text()
    assert "wgmma.mma_async" in text
    assert (f"#define {macro}_MODES(T, D) \\\n  {macro}(T, D, 0) "
            f"{macro}(T, D, 1) {macro}(T, D, 2)") in units[unit]
    for t in ("__nv_bfloat16", "__half"):
        for d in (64, 128):
            assert f"{macro}_MODES({t}, {d})" in units[unit]


def test_no_wmma_code_is_left_in_the_port():
    """Every tensor-core product of the port is a wgmma kernel: no source
    under csrc/ includes the wmma API or calls it."""
    for path in sorted(_build.CSRC.glob("*.cu*")):
        text = path.read_text()
        assert "<mma.h>" not in text and "wmma::" not in text, path.name
