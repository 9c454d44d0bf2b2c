"""Prefetching pair loader (counterpart of ``nct_tpu/data/loader.py``).

The reference decodes and resizes each pair serially on its main thread
(main.cu:483-522).  ``PairLoader`` decodes every image of a pairs list on a
thread pool ahead of the consumer, so host IO overlaps the card's work on
the pair before.  Decoding is ``io.imread_bgr`` (PNG through ``data.png``
and JPEG through ``data.jpeg``, neither of which needs an imaging library)
and the longer-side cap is ``io.cap_max_size``; ``zlib``, numpy and the
decoder's ctypes call release the GIL in their heavy work.  A file that
cannot be read (``OSError``) makes its pair unreadable; a decoder that
cannot be built (``RuntimeError``) is raised to the consumer.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from nct_tpu_torch import io


def _load(path: str, max_size: int) -> np.ndarray | None:
    try:
        return io.cap_max_size(io.imread_bgr(path), max_size)
    except OSError:
        return None


class PairLoader:
    """Prefetching iterator over a pairs list.

    Iteration yields (cnt, stl) uint8 BGR arrays already capped to
    ``max_size``, or None for a pair whose content or style cannot be read
    (the reference continues past those, main.cu:484-497).  Every image is
    submitted to ``threads`` workers at construction.
    """

    def __init__(self, pair_paths: Sequence[tuple[str, str]], max_size: int,
                 threads: int = 4):
        self._n = len(pair_paths)
        self._pool = ThreadPoolExecutor(max_workers=max(1, threads))
        self._futures = [self._pool.submit(_load, path, max_size)
                         for pair in pair_paths for path in pair]

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        for i in range(self._n):
            cnt = self._futures[2 * i].result()
            stl = self._futures[2 * i + 1].result()
            self._futures[2 * i] = self._futures[2 * i + 1] = None
            yield (cnt, stl) if cnt is not None and stl is not None else None

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
