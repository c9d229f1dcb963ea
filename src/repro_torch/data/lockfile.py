"""Cross-process lock files for shared on-disk state (a copy of
``repro.data.lockfile``; plain Python).

One tiny primitive, ``FileLock``, used everywhere two processes (or two
threads of a serving stack) can touch the same directory:

  * ``repro_torch.train.online`` -- two trainers sharing one ``SignatureCache``
    directory serialize their populate passes on the cache lock, so the
    TTL sweep of one never interleaves with the shard writes of the
    other.

The lock is the classic ``O_CREAT | O_EXCL`` create-wins protocol: the
lock file's existence IS the lock, its content (pid + timestamp) is
diagnostics only.  ``stale_s`` lets a waiter break a lock whose mtime
has not moved for that long -- the crash-recovery story for a holder
that died without ``release`` (removal is best-effort and racy only
between *breakers*, who then re-contend on ``O_EXCL``).
"""

from __future__ import annotations

import os
import time


class LockTimeout(TimeoutError):
    """Raised when ``FileLock.acquire`` exceeds its ``timeout_s``."""


class FileLock:
    """An ``O_CREAT | O_EXCL`` lock file; reentrant within one instance.

    Use as a context manager::

        with FileLock(os.path.join(d, ".lock")):
            ...mutate d...

    ``timeout_s`` bounds the acquire wait (``LockTimeout`` on expiry);
    ``stale_s`` (optional) treats a lock file untouched for that many
    seconds as abandoned and breaks it.
    """

    def __init__(self, path: str, *, timeout_s: float = 30.0,
                 poll_s: float = 0.01, stale_s: float | None = None):
        self.path = path
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.stale_s = stale_s
        self._depth = 0

    @property
    def held(self) -> bool:
        return self._depth > 0

    def _try_break_stale(self) -> None:
        if self.stale_s is None:
            return
        try:
            if time.time() - os.path.getmtime(self.path) > self.stale_s:
                os.remove(self.path)      # racy only vs other breakers;
        except OSError:                   # everyone re-contends on O_EXCL
            pass

    def acquire(self) -> "FileLock":
        if self._depth:                   # reentrant within this instance
            self._depth += 1
            return self
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._try_break_stale()
                if time.monotonic() >= deadline:
                    raise LockTimeout(
                        f"could not acquire {self.path} within "
                        f"{self.timeout_s}s (holder: "
                        f"{self._holder_info()!r})")
                time.sleep(self.poll_s)
                continue
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()} {time.time():.3f}\n")
            self._depth = 1
            return self

    def _holder_info(self) -> str:
        try:
            with open(self.path) as f:
                return f.read().strip()
        except OSError:
            return "?"

    def release(self) -> None:
        if not self._depth:
            raise RuntimeError(f"release of unheld lock {self.path}")
        self._depth -= 1
        if self._depth == 0:
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
