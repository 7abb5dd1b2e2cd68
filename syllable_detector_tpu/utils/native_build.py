"""Shared on-demand build helper for the native C++ components.

Three modules ship a C++ counterpart that is compiled on first use with
the system toolchain (the reference links its native pieces at Xcode
build time — project.pbxproj targets; here the build is lazy so the
Python package works without a compile step): runtime.ring_buffer
(native/ring_buffer.cpp), runtime.arduino NativeFirmwareTransport
(native/arduino_firmware.cpp), and utils.av_codec (native/av_codec.cpp).
They share this one build-and-rename sequence instead of three drifting
copies.

Each build is keyed on what it was built from: the library lands at
``native/build/lib<stem>-<key>.so``, where the key hashes the source
bytes, the compiler flags and link line (and the CPU when the flags say
``-march=native``). An edited source, or a copy of the tree on another
machine, therefore builds afresh instead of loading a stale ``.so``.

The compile goes to a per-process temp name and is ``os.rename``d into
place — atomic on POSIX — so another process racing the first build
(parallel pytest, a ResilientDetector child) can never ``CDLL`` a
half-written ``.so``; a failed compile removes its temp file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Sequence

__all__ = ["NativeBuildError", "ensure_native_library"]


class NativeBuildError(RuntimeError):
    """The on-demand g++ build of a native component failed. ``stderr``
    carries the compiler output (empty when the toolchain itself or the
    source file was unavailable)."""

    def __init__(self, message: str, stderr: str = ""):
        super().__init__(message)
        self.stderr = stderr


def _cpu_signature() -> bytes:
    """The CPU's model and feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            return b"".join(
                line for line in fh
                if line.startswith((b"model name", b"flags"))
            )
    except OSError:
        return b""


def library_path(
    src: str, link: Sequence[str] = (), extra_flags: Sequence[str] = ()
) -> str:
    """Where the build of ``src`` with these flags lives."""
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read())
    key.update(repr((tuple(extra_flags), tuple(link))).encode())
    if "-march=native" in extra_flags:
        key.update(_cpu_signature())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(
        os.path.dirname(os.path.abspath(src)), "build",
        f"lib{stem}-{key.hexdigest()[:16]}.so",
    )


def ensure_native_library(
    src: str,
    link: Sequence[str] = (),
    extra_flags: Sequence[str] = (),
) -> str:
    """Build ``src`` into its keyed shared library unless that exact build
    exists; returns the library path.

    Raises :class:`NativeBuildError` when the source is missing, g++ is
    unavailable, or the compile fails.
    """
    if not os.path.exists(src):
        raise NativeBuildError(f"native source {src} not found")
    out = library_path(src, link, extra_flags)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-Wall", *extra_flags, "-std=c++17", "-fPIC",
             "-shared", "-o", tmp, src, *link],
            capture_output=True,
        )
    except OSError as e:
        raise NativeBuildError(f"C++ toolchain unavailable (g++: {e})") from e
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise NativeBuildError(
            f"native compile of {os.path.basename(src)} failed",
            stderr=proc.stderr.decode(errors="replace"),
        )
    os.rename(tmp, out)
    return out
