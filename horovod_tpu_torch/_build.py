"""Build the package's CUDA sources into shared libraries and load them.

A library is one or more translation units under ``csrc/``
(``LIBRARIES``). Each unit compiles with its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects link into
``_build/lib<name>-<hash>.so`` on first use, loaded with ctypes. The file
name carries a hash of the library's sources and of every header in
``csrc/``, so an edited source rebuilds and a stale library is never
loaded. There is no fallback: a missing ``nvcc`` or a failed compile raises.

The native core (``csrc/core/``, the port's copy of the repo's ``csrc/``)
builds the same way with ``g++``: one process compiles and links every
``.cc`` into ``_build/libhvdcore-<hash>.so`` (and ``test_core`` into
``_build/test_core-<hash>``), under a file lock so that processes that
build at once wait for one another.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
#: Translation units of each library; the first holds its C entry points.
LIBRARIES = {
    "flash_attention": ("flash_attention.cu", "flash_fwd_sm90.cu",
                        "flash_dkv_sm90.cu", "flash_dq_sm90.cu"),
}

CORE_DIR = CSRC / "core"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    return next((c for c in candidates if c and os.access(c, os.X_OK)), None)


def sources(name):
    return [CSRC / s for s in LIBRARIES[name]]


def library_path(name):
    digest = hashlib.sha256()
    for path in sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _run(procs):
    """Waits for ``{key: Popen}``; returns ``{key: output}`` and the keys
    that failed."""
    logs, failed = {}, []
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(key)
    return logs, failed


def build(names):
    """Compile every named library that has no current one: one nvcc per
    translation unit, all started together, then one link per library.
    Returns ``{source or library name: compiler output}`` for what it
    built. Raises RuntimeError if a compile or a link fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "horovod_tpu_torch: nvcc not found (set CUDA_HOME or put nvcc on "
            "PATH); the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects, procs = {}, {}
    for name in todo:
        for src in sources(name):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objects.setdefault(name, []).append(obj)
            procs[src.name] = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = _run(procs)
    if not failed:
        links = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".{tag}")
            links[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objects[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        link_logs, failed = _run({n: p for n, (p, _) in links.items()})
        logs.update(link_logs)
        for name, (_, tmp) in links.items():
            if name in failed:
                tmp.unlink(missing_ok=True)
            else:
                # atomic: a reader never sees half a file
                os.replace(tmp, library_path(name))
    for objs in objects.values():
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(
            f"{key}:\n{logs[key]}" for key in failed))
    return logs


def load(name):
    """The ctypes library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def _core_sources(with_test):
    return sorted(p for p in CORE_DIR.glob("*.cc")
                  if with_test or p.name != "test_core.cc")


def core_path(test=False):
    """``_build/libhvdcore-<hash>.so``, or with ``test`` the ``test_core``
    binary; the hash covers every source and header of ``csrc/core/``."""
    digest = hashlib.sha256()
    for path in sorted(CORE_DIR.glob("*.cc")) + sorted(CORE_DIR.glob("*.h")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    stem = "test_core" if test else "libhvdcore"
    suffix = "" if test else ".so"
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}{suffix}"


def build_core(test=False):
    """Build the native core library (or its ``test_core`` binary) if it is
    missing: one ``g++ -c`` per source, all started together, then one
    link; returns its path. Raises RuntimeError if g++ is missing or
    fails."""
    out = core_path(test)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("horovod_tpu_torch: g++ not found; the native "
                           "core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # built by another process meanwhile
            return out
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        objs = BUILD_DIR / f"{out.name}.{os.getpid()}.obj"
        objs.mkdir()
        try:
            compiles = [
                subprocess.Popen(
                    [cxx, *CXX_FLAGS, "-c", str(src), "-o",
                     str(objs / f"{src.stem}.o")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                for src in _core_sources(test)]
            logs = [(p, p.communicate()[0]) for p in compiles]
            failed = [text for p, text in logs if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [cxx, *CXX_FLAGS, *(() if test else ("-shared",)), "-o",
                     str(tmp), *sorted(map(str, objs.glob("*.o")))],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if link.returncode != 0:
                    failed = [link.stdout]
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed building {out.name}:\n"
                                   + "\n".join(failed))
        finally:
            shutil.rmtree(objs, ignore_errors=True)
        os.replace(tmp, out)   # atomic: a reader never sees half a file
    return out
