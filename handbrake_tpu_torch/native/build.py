"""Build + load the native host stages (g++, cached by source hash).

Three libraries: the slice coder ``hb264.cpp`` (``get_lib``), the H.264
decoder ``hbdec264.cpp`` (``get_decoder_lib``) and the baseline JPEG
decoder ``hbdecmjpeg.cpp`` (``get_mjpeg_lib``), each a shared library of
its own, so they build in parallel.  A library goes into the package's ``_build`` directory (listed in
``.gitignore``), keyed by the sha256 of its sources and generated
tables, so a rebuild happens only when they change.  A failed build
raises: there is no pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lock = threading.Lock()
_lib = [None]
_dec_lock = threading.Lock()
_dec_lib = [None]
_mjpeg_lock = threading.Lock()
_mjpeg_lib = [None]


def compile_shared(name: str, files: dict, cmd_for, timeout: int = 600
                   ) -> str:
    """Write ``files`` (name → text) into a work directory keyed by
    their hash and compile them once into ``<name>_<key>.so``.

    cmd_for(workdir, out_path) returns the compiler command.  The
    output is written under a per-process temporary name and published
    with os.replace, so concurrent first builds (test workers) never
    load a half-written library."""
    h = hashlib.sha256()
    for k in sorted(files):
        h.update(k.encode() + b"\0" + files[k].encode() + b"\0")
    key = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"{name}_{key}.so")
    if os.path.exists(so_path):
        return so_path
    workdir = os.path.join(BUILD_DIR, f"{name}_{key}_src.{os.getpid()}")
    os.makedirs(workdir, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        for fname, text in files.items():
            with open(os.path.join(workdir, fname), "w") as f:
                f.write(text)
        cmd = cmd_for(workdir, tmp)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=timeout)
        except FileNotFoundError as e:
            raise RuntimeError(f"{name}: compiler not found: {cmd[0]}") from e
        if r.returncode != 0:
            raise RuntimeError(f"{name}: build failed ({' '.join(cmd)}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def nvcc_command(source: str, extra=()):
    """cmd_for of ``compile_shared`` for one CUDA source with a plain C
    interface: nvcc for sm_90a (no fast math), a shared library, with
    the `extra` flags."""
    def cmd(workdir, out):
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            nvcc = shutil.which("nvcc") or "nvcc"
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                *extra, os.path.join(workdir, source), "-o", out]
    return cmd


def _sources(names) -> dict:
    from . import gen_tables
    files = {"cavlc_tables.h": gen_tables.generate()}
    for name in names:
        with open(os.path.join(_DIR, name)) as f:
            files[name] = f.read()
    return files


def _gxx(source: str):
    def cmd(workdir, out):
        return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-I",
                workdir, os.path.join(workdir, source), "-o", out]
    return cmd


def _bind(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.hb264_encode_i_slice.restype = ctypes.c_int
    lib.hb264_encode_i_slice.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, u8p, u8p, ctypes.c_int]
    lib.hb264_encode_p_slice.restype = ctypes.c_int
    lib.hb264_encode_p_slice.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        u8p, u8p, u8p,
        i16p, i32p, i16p, i8p, i8p, i16p, i16p, i16p, i16p, i8p, i8p,
        u8p, u8p, u8p, u8p, ctypes.c_int, i8p, i8p]
    lib.hb264_deblock.restype = None
    lib.hb264_deblock.argtypes = [
        u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i8p, i32p, i8p, i8p]
    lib.hb264_rbsp_to_ebsp.restype = ctypes.c_int
    lib.hb264_rbsp_to_ebsp.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int]
    return lib


def _bind_decoder(lib):
    """The H.264 decoder's entry points, bound as the reference binds
    them (handbrake_tpu/native/build.py)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.hbdec264_create.restype = ctypes.c_void_p
    lib.hbdec264_free.argtypes = [ctypes.c_void_p]
    lib.hbdec264_error.restype = ctypes.c_char_p
    lib.hbdec264_error.argtypes = [ctypes.c_void_p]
    lib.hbdec264_send_nal.restype = ctypes.c_int
    lib.hbdec264_send_nal.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
    lib.hbdec264_get_frame.restype = ctypes.c_int
    lib.hbdec264_get_frame.argtypes = [
        ctypes.c_void_p, u8p, u8p, u8p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.hbdec264_geometry.restype = ctypes.c_int
    lib.hbdec264_geometry.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    return lib


def get_lib():
    """Build (once) and return the loaded native slice coder."""
    with _lock:
        if _lib[0] is None:
            so = compile_shared(
                "hb264", _sources(("hb264.cpp", "cabac264.h",
                                   "cabac_tables_h264.h")),
                _gxx("hb264.cpp"), timeout=300)
            _lib[0] = _bind(ctypes.CDLL(so))
        return _lib[0]


def get_decoder_lib():
    """Build (once) and return the loaded native H.264 decoder."""
    with _dec_lock:
        if _dec_lib[0] is None:
            so = compile_shared(
                "hbdec264", _sources(("hbdec264.cpp",
                                      "cabac_tables_h264.h")),
                _gxx("hbdec264.cpp"), timeout=300)
            _dec_lib[0] = _bind_decoder(ctypes.CDLL(so))
        return _dec_lib[0]


def _bind_mjpeg(lib):
    """The MJPEG decoder's entry points, bound as the reference binds
    them (handbrake_tpu/native/build.py)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hbdecmjpeg_info.restype = ctypes.c_int
    lib.hbdecmjpeg_info.argtypes = [u8p, ctypes.c_int, ip, ip, ip, ip]
    lib.hbdecmjpeg_decode.restype = ctypes.c_int
    lib.hbdecmjpeg_decode.argtypes = [u8p, ctypes.c_int, u8p, u8p, u8p]
    return lib


def get_mjpeg_lib():
    """Build (once) and return the loaded native MJPEG decoder."""
    with _mjpeg_lock:
        if _mjpeg_lib[0] is None:
            with open(os.path.join(_DIR, "hbdecmjpeg.cpp")) as f:
                files = {"hbdecmjpeg.cpp": f.read()}
            so = compile_shared("hbdecmjpeg", files, _gxx("hbdecmjpeg.cpp"),
                                timeout=300)
            _mjpeg_lib[0] = _bind_mjpeg(ctypes.CDLL(so))
        return _mjpeg_lib[0]
