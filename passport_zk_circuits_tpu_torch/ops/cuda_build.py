"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Takes the place of the TPU package's ``pallas_field.use_pallas`` gate: there
is no gate here. The kernel wrappers call ``library()`` the first time a CUDA
tensor reaches them; it compiles every ``csrc/*.cu`` with nvcc for sm_90a,
one nvcc process per source, all started together, and links the objects
once into a shared library with a plain C interface, keyed by a hash of the
sources and the flags, under ``passport_zk_circuits_tpu_torch/_build/``, and
loads it with ctypes. A build that fails raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "pzk_sha256": [_P, _P, _I, _I, _I, _P],
    "pzk_sha256_many": [_P, _P, _P, _P, _I, _I, _P],
    "pzk_rsa_pow": [_P, _P, _P, _P, _I, _I, ctypes.c_ulonglong, _P, _P],
    "pzk_poseidon": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pzk_smt_climb": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "pzk_ladder": [_P, _P, _P, _P, _I, _I, _P],
    "pzk_ladder_affine": [_P, _P, _P, _P, _I, _I, _P],
    "pzk_fr_mul": [_P, _P, _I, _P, _I, _P],
    "pzk_fr_mul_chain": [_P, _P, _I, _P, _I, _I, _P],
    "pzk_loop": [_I, _P, _P, _P, _I, _I, _P],
    "pzk_probe": [_I, _P, _P, _P, _I, _I, _P],
    "pzk_probe_battery": [_I, _P, _P, _P, _P, _P, _P, _P, _P],
    "pzk_msm_points": [_I, _P, _P, _L, _P, _P],
    "pzk_msm_round": [_I, _P, _P, _P, _P, _L, _L, _P, _P],
    "pzk_msm_sum": [_I, _P, _I, _P, _P, _P, _L, _P, _P, _P],
    "pzk_msm_reduce": [_I, _P, _P, _P, _P, _L, _P, _P, _P],
    "pzk_msm_horner": [_I, _P, _I, _I, _L, _P, _P, _P],
    "pzk_fixed_base": [_I, _P, _L, _P, _P, _P, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _key() -> str:
    """Hash of the flags and every kernel source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


# seconds of each nvcc process of the last build in this process, by the
# source it compiled (or "link")
BUILD_SECONDS = {}


def _run_all(cmds, names, log) -> None:
    """Run the commands in parallel, append their output and seconds to
    log (and, under names, to BUILD_SECONDS), and raise if any failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=CSRC, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [None] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        BUILD_SECONDS[names[i]] = time.perf_counter() - t0
    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = []
    for cmd, name, proc, out in zip(cmds, names, procs, outs):
        log.append(" ".join(cmd) + "\n" + out + "\n("
                   f"{BUILD_SECONDS[name]:.1f} s)")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build(so: pathlib.Path) -> None:
    """Compile every source at once, one nvcc each, then link them into
    so; the objects and build.log go next to so."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [so.parent / f"{tag}.{f.stem}.o" for f in sources]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = []
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                  for f, o in zip(sources, objs)],
                 [f.name for f in sources], log)
        _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *[str(o) for o in objs]]], ["link"], log)
    finally:
        (so.parent / "build.log").write_text("\n".join(log))
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    so = BUILD_DIR / f"libpzk_kernels_{_key()}.so"
    if not so.exists():
        build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pzk_error_string.argtypes = [ctypes.c_int]
    lib.pzk_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_report(text: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} for every
    entry function in nvcc's -Xptxas -v output (build.log); a kernel's
    name is shortened to its identifier and template values, as
    sha256_kernel or poseidon_kernel<6>."""
    report, entry, props, spills = {}, None, None, {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            report[kernel_name(entry)] = (int(m.group(1)),
                                          *spills.get(entry, (0, 0)))
    return report


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as its identifier and template arguments:
    int values and (namespace-qualified) type names, as poseidon_kernel<6>
    or msm_sum_kernel<fq::F1>."""
    m = re.match(r"_Z(\d+)", mangled)
    if m is None:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + len(name):]
    if not rest.startswith("I"):
        return name
    rest, vals = rest[1:], []
    while rest and rest[0] != "E":
        lit = re.match(r"Li(-?\d+)E", rest)
        if lit:
            vals.append(lit.group(1))
            rest = rest[lit.end():]
            continue
        nested = rest.startswith("N")       # N <len><id> <len><id> ... E
        rest, parts = rest[nested:], []
        while rest[:1].isdigit():
            n = re.match(r"\d+", rest)
            parts.append(rest[n.end():n.end() + int(n.group(0))])
            rest = rest[n.end() + int(n.group(0)):]
            if not nested:
                break
        if not parts:
            return name                     # an encoding not read here
        rest = rest[nested:]
        vals.append("::".join(parts))
    return name + "<" + ", ".join(vals) + ">"


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().pzk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, entry: str, like, *args) -> None:
    """Call the library's C entry point `entry` with args and, last, the
    current stream of like's device, with like's device made the host
    thread's current device around the call (a kernel launch goes to the
    current device, which in a process with several cards need not be the
    tensors'); raise on a non-zero code. Every kernel wrapper launches
    through here."""
    fn = getattr(library(), entry)
    with torch.cuda.device(like.device):
        rc = fn(*args, stream_of(like))
    check(rc, name)


def require_cuda_int64(name: str, *tensors) -> None:
    """The kernels take contiguous int64 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
