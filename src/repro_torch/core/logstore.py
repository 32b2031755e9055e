"""The record type the serving path reads and the crash-safe file replace
its committed offsets use — the port's own copy of that part of
``repro.core.logstore``."""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


def atomic_write_bytes(path: Path, data: bytes) -> None:
    """Crash-safe whole-file replace: write a tmp file, fsync its fd, rename
    over ``path``, then fsync the parent directory. The plain
    ``write + os.replace`` idiom is only atomic against a *process* crash —
    after a machine crash the rename target can be torn, which loses the
    previous contents too."""
    tmp = path.with_name(path.name + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        view = memoryview(data)
        while view:                # os.write may land short: never fsync +
            view = view[os.write(fd, view):]   # rename a truncated payload
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
    except OSError:                # platforms without O_RDONLY dir opens
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


@dataclass(frozen=True, slots=True)
class LogRecord:
    """One committed record, as handed to consumers."""

    topic: str
    partition: int
    offset: int
    key: bytes
    value: bytes
