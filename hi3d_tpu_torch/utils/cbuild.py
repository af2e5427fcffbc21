"""Small C helpers of the host side (`csrc/png_unfilter.c`,
`csrc/jpeg_decode.c`), compiled at first use with the host C compiler
(`cc`, `gcc` or `$CC`, `-O3 -shared -fPIC`) into build/host/ under a name
that carries the source's hash, and loaded with ctypes.

One thread of a process builds a library while the others wait (the
training loader reads from several threads); the library is written under a
name of its own and renamed into place, so processes that build it at once
do not race. Without a compiler the first use raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CFLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()


def load(source: str, stem: str, user: str, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The library of `csrc/<source>`, built once per source hash as
    `build_dir`/lib<stem>_<hash>.so and loaded; `user` names the caller in
    errors. The caller keeps the handle."""
    with _lock:
        path = CSRC / source
        digest = hashlib.sha256(path.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
        out = build_dir / f"lib{stem}_{digest}.so"
        if not out.exists():
            cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError(f"{user}: no C compiler (cc, gcc or $CC) to build {source}")
            build_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=f"{out.name}.", suffix=".tmp", dir=build_dir)
            os.close(fd)
            try:
                done = subprocess.run([cc, *CFLAGS, "-o", tmp, str(path)],
                                      capture_output=True, text=True)
                if done.returncode != 0:
                    raise RuntimeError(f"{user}: building {source} failed:\n{done.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(str(out))
