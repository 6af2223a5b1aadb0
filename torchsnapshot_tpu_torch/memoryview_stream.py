"""Read-only file-like wrapper over a memoryview, so a consumer that wants a
stream (an object-store SDK) reads staged buffers without a copy.

Counterpart of ``torchsnapshot_tpu/memoryview_stream.py``.
"""

from __future__ import annotations

import io
from typing import Optional


class MemoryviewStream(io.RawIOBase):
    def __init__(self, mv: memoryview) -> None:
        self._mv = mv.cast("B")
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = pos
        elif whence == io.SEEK_CUR:
            self._pos += pos
        elif whence == io.SEEK_END:
            self._pos = self._mv.nbytes + pos
        else:
            raise ValueError(f"Invalid whence: {whence}")
        self._pos = max(0, min(self._pos, self._mv.nbytes))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: Optional[int] = -1) -> bytes:
        if size is None or size < 0:
            end = self._mv.nbytes
        else:
            end = min(self._pos + size, self._mv.nbytes)
        data = bytes(self._mv[self._pos : end])
        self._pos = end
        return data

    def readinto(self, b) -> int:
        n = min(len(b), self._mv.nbytes - self._pos)
        b[:n] = self._mv[self._pos : self._pos + n]
        self._pos += n
        return n
