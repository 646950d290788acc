"""The ``nvcc`` driver shared by the port's kernel libraries.

Each library is a set of CUDA C++ sources under ``csrc/`` with a plain C
interface, compiled for ``sm_90a`` into one shared object and loaded with
``ctypes``.  :func:`build_libraries` starts one ``nvcc`` per source of every
library that is not built yet, all at once, then links each library; the
file name carries a hash of the library's sources, headers and flags, so a
stale build is never picked up.  Nothing is compiled when this module is
imported: the wrappers build at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

#: Where the libraries are built: ``build/repro_torch`` at the root of the
#: checkout (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


@dataclass(frozen=True)
class Library:
    """One shared library: its stem, sources, headers and compiler flags."""

    name: str
    sources: tuple
    headers: tuple
    flags: tuple

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(self.flags + ("-shared",)).encode())
        for name in self.sources + self.headers:
            h.update((CSRC / name).read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


@dataclass(frozen=True)
class BuildResult:
    path: Path            # the shared library
    seconds: float        # 0.0 when an up-to-date library was found
    cached: bool
    log: str              # nvcc / ptxas -v output (registers, spills)


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def nvcc_release() -> str:
    """The ``release X.Y, VX.Y.Z`` part of ``nvcc --version``."""
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return next((ln.split("release", 1)[1].strip()
                 for ln in out.splitlines() if "release" in ln), "unknown")


def build_libraries(libs) -> list[BuildResult]:
    """Build every library of ``libs`` that is not built yet: one ``nvcc``
    per source of all of them started together, then one link each.  An
    up-to-date library is returned as is.  Raises with the compiler's
    output when a source does not compile or a library does not link."""
    paths = [lib.path() for lib in libs]
    todo = [(lib, p) for lib, p in zip(libs, paths) if not p.exists()]
    seconds = {}
    logs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        jobs = []
        for lib, p in todo:
            tag = f"{p.stem}.tmp{os.getpid()}"
            for src in lib.sources:
                obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
                jobs.append((lib, src, obj, subprocess.Popen(
                    [nvcc, *lib.flags, "-c", "-I", str(CSRC), "-o", str(obj),
                     str(CSRC / src)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
        texts = {id(job): job.communicate()[0] for *_, job in jobs}
        failed = [(src, job.returncode, texts[id(job)])
                  for _, src, _, job in jobs if job.returncode != 0]
        for lib, p in todo:
            mine = [(obj, texts[id(job)]) for owner, _, obj, job in jobs
                    if owner is lib]
            text = "".join(t for _, t in mine)
            tmp = BUILD_DIR / f"{p.stem}.tmp{os.getpid()}.so"
            if not failed:
                link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                       *(str(o) for o, _ in mine)],
                                      capture_output=True, text=True)
                text += link.stdout + link.stderr
                if link.returncode != 0:
                    failed.append((f"link {lib.name}", link.returncode,
                                   link.stdout + link.stderr))
            for obj, _ in mine:
                obj.unlink(missing_ok=True)
            if not failed:
                p.with_suffix(".log").write_text(text)
                os.replace(tmp, p)
            logs[lib.name] = text
            seconds[lib.name] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{src} ({rc}):\n{text}" for src, rc, text in failed))
    out = []
    for lib, p in zip(libs, paths):
        if lib.name in seconds:
            out.append(BuildResult(p, seconds[lib.name], False,
                                   logs[lib.name]))
        else:
            log = p.with_suffix(".log")
            out.append(BuildResult(p, 0.0, True,
                                   log.read_text() if log.exists() else ""))
    return out


def load(lib: Library, signatures: dict) -> ctypes.CDLL:
    """Build ``lib`` if needed and load it; ``signatures`` maps each C entry
    point to its argument types (the stream, last, is added), so ctypes
    passes pointers at full width."""
    cdll = ctypes.CDLL(str(build_libraries([lib])[0].path))
    for name, argtypes in signatures.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return cdll


def launch(cdll, name, device, *args):
    """Call the C entry point ``<name>_launch`` of ``cdll`` with ``args`` on
    the current stream of ``device``; raise on the CUDA error it returns."""
    fn = getattr(cdll, f"{name}_launch")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
