"""The port's copy of the native core (``horovod_tpu_torch/csrc/core/``):
it builds with one g++ process into the package's ``_build/`` without
touching ``csrc/`` or ``horovod_tpu/``; its ``test_core`` passes, including
the delegated null-input case; it differs from the repo's ``csrc/`` only in
``Core::Enqueue`` and that test; and the ctypes binding drives a delegated
negotiation across two in-process ranks with tensors that never enter the
core."""

import filecmp
import os
import subprocess
import threading

import pytest
import torch

from horovod_tpu_torch import _build, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILT = (".o", ".so", ".pyc")


def _snapshot():
    """(path, mtime) of every source file under csrc/ and horovod_tpu/
    (build products of the JAX package's own make are left out)."""
    out = {}
    for top in ("csrc", "horovod_tpu"):
        for root, dirs, files in os.walk(os.path.join(REPO, top)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                if f.endswith(BUILT) or f == "test_core":
                    continue
                p = os.path.join(root, f)
                out[p] = os.stat(p).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def fresh_build(tmp_path_factory):
    """The library and test_core built from scratch in a private build
    directory, with the source trees' snapshot before and after."""
    build_dir = tmp_path_factory.mktemp("build")
    saved = _build.BUILD_DIR
    before = _snapshot()
    _build.BUILD_DIR = build_dir
    try:
        lib, test = _build.build_core(), _build.build_core(test=True)
    finally:
        _build.BUILD_DIR = saved
    return build_dir, lib, test, before, _snapshot()


def test_the_copy_builds_into_the_build_directory(fresh_build):
    build_dir, lib, test, _, _ = fresh_build
    assert lib.parent == build_dir and lib.name.startswith("libhvdcore-")
    assert lib.suffix == ".so" and test.name.startswith("test_core-")
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        ["core.lock", lib.name, test.name])
    assert lib.name == _build.core_path().name   # named by content


def test_the_build_touches_nothing_of_csrc_or_the_jax_package(fresh_build):
    _, _, _, before, after = fresh_build
    assert after == before


def test_test_core_passes_with_the_null_input_delegated_case(fresh_build):
    _, _, test, _, _ = fresh_build
    out = subprocess.run([str(test)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "delegated null input: OK" in out.stdout
    assert "test_core: all passed" in out.stdout


def test_the_copy_differs_from_csrc_only_in_enqueue():
    core = os.path.join(REPO, "horovod_tpu_torch", "csrc", "core")
    ref = os.path.join(REPO, "csrc")
    names = sorted(f for f in os.listdir(core))
    assert names == sorted(f for f in os.listdir(ref)
                           if f.endswith((".cc", ".h")))
    differ = [f for f in names
              if not filecmp.cmp(os.path.join(core, f),
                                 os.path.join(ref, f), shallow=False)]
    assert differ == ["core.cc", "test_core.cc"]
    with open(os.path.join(core, "core.cc")) as f:
        mine = f.read().splitlines()
    with open(os.path.join(ref, "core.cc")) as f:
        theirs = f.read().splitlines()
    start = theirs.index("int64_t Core::Enqueue(int ps_id, const Request& "
                         "req, const void* data,")
    end = theirs.index("void Core::SetFusionThreshold(int64_t bytes) {")
    # Identical outside Enqueue.
    assert mine[:start] == theirs[:start]
    assert mine[len(mine) - (len(theirs) - end):] == theirs[end:]


def test_delegated_negotiation_with_tensors_that_stay_outside(tmp_path):
    """Two in-process ranks enqueue allreduces with shape and dtype only;
    the core fuses them into one delegated response whose handles the
    caller completes without data; a request the core runs itself still
    needs its bytes."""
    results, errors = {}, []

    def rank_main(rank):
        try:
            core = native.NativeCore(rank, 2, transport="local",
                                     peers=f"port-test-{os.getpid()}",
                                     delegate_data_ops=True)
            a = torch.empty(4, 8, dtype=torch.bfloat16)
            b = torch.empty(5, dtype=torch.bfloat16)
            ha = core.enqueue(0, "a", native.REQ_ALLREDUCE, a,
                              with_data=False)
            hb = core.enqueue(0, "b", native.REQ_ALLREDUCE, b,
                              with_data=False)
            with pytest.raises(native.NativeError, match="invalid"):
                core.enqueue(0, "x", native.REQ_ALLTOALL, b,
                             splits=[5, 0], with_data=False)
            seen = []
            while core.poll(ha) == 0 or core.poll(hb) == 0:
                assert core.run_cycle() >= 0
                tok = core.next_delegated()
                while tok:
                    d = core.delegated(tok)
                    seen.append(d)
                    for h in d["handles"]:
                        core.delegated_complete(h)
                    core.delegated_finish(tok)
                    tok = core.next_delegated()
            results[rank] = (seen, core.poll(ha), core.poll(hb))
            core.request_shutdown()
            while not core.shutdown_complete():
                core.run_cycle()
            core.close()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for rank in range(2):
        seen, sa, sb = results[rank]
        assert (sa, sb) == (1, 1)
        (d,) = seen
        assert d["type"] == native.REQ_ALLREDUCE
        assert native.ENUM_TO_DTYPE[d["dtype"]] == torch.bfloat16
        assert d["sizes"] == [32, 5] and len(d["handles"]) == 2
