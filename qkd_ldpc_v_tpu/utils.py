"""Small host-side utilities (reference: src/utils.cpp)."""

from __future__ import annotations

import os
import weakref
from pathlib import Path
from typing import Any, List, Optional


class PlanCache:
    """Identity-keyed cache that does not pin its key objects.

    Decode plans / compiled steps are cached per matrix object. Keying by
    ``id()`` alone risks stale hits after id reuse, and storing the matrix
    strongly (the round-2 pattern) keeps every matrix of a long multi-matrix
    campaign alive forever. This cache stores a ``weakref`` to the key
    object: entries self-evict when the matrix is garbage collected, and a
    hit is only returned when the weakref still points at the *same* object
    (id-reuse safe)."""

    def __init__(self) -> None:
        self._data: dict = {}

    def __len__(self) -> int:
        return len(self._data)

    def get(self, obj: Any, extra: tuple = ()) -> Optional[Any]:
        key = (id(obj),) + extra
        entry = self._data.get(key)
        if entry is not None and entry[0]() is obj:
            return entry[1]
        return None

    def put(self, obj: Any, value: Any, extra: tuple = ()) -> None:
        key = (id(obj),) + extra
        data = self._data
        ref = weakref.ref(obj, lambda _r, _k=key: data.pop(_k, None))
        data[key] = (ref, value)


def get_file_paths_in_directory(directory, extension: str) -> List[Path]:
    """Sorted file paths with the given extension
    (reference: src/utils.cpp:20-34; throws when the directory is missing,
    returns lexicographically ordered paths like fs::directory_iterator on
    the reference's sorted-by-name volumes)."""
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"Directory does not exist: {directory}")
    return sorted(p for p in directory.iterdir() if p.suffix == extension)


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    The decoder's while-loop steps take seconds to compile, so every later
    process with the same shapes starts faster. When ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX already caches there and nothing else is set. Otherwise the
    cache lives at one fixed path inside the checkout, ``<repo>/.jax_cache``
    (fixed because the path is part of the cache key). Safe to call more
    than once.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    path = Path(__file__).resolve().parent.parent / ".jax_cache"
    path.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))


def format_duration(seconds: float) -> str:
    """``00h-00m-00s`` duration string (reference: src/main.cpp:180-183)."""
    total = int(seconds)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}h-{m:02d}m-{s:02d}s"
