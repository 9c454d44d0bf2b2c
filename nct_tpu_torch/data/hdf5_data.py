"""HDF5Data source: batches straight from HDF5 files (port of
``nct_tpu/data/hdf5_data.py``).

Rebuilds the reference's HDF5DataLayer (src/caffe/layers/
hdf5_data_layer.cpp: ``hdf5_data_param { source batch_size shuffle }``;
the source file lists one .h5 path per line, every listed file holds a
dataset per top, ``shuffle`` permutes both the file order and the row
order within each file, and batches wrap across file boundaries forever).

Caffe's N x C x H x W layout is kept as read (the JAX source transposes
4-D datasets to NHWC).  Datasets are read whole per file, as
hdf5_load_nd_dataset does.  The row permutation is redrawn at each file
load and the file permutation at each pass over the files, in the JAX
source's order.  ``h5py`` is imported when a source is built.
"""

from __future__ import annotations

import json
import os

import numpy as np


class HDF5DataSource:
    """Tuples of per-top float32 arrays from a list of HDF5 files."""

    def __init__(self, layer_cfg: dict, phase: str = "TRAIN",
                 seed: int = 0):
        import h5py

        hdp = layer_cfg.get("hdf5_data_param", {}) or {}
        tops = layer_cfg.get("top")
        self.tops = [str(t) for t in
                     (tops if isinstance(tops, list) else [tops])]
        self.batch_size = int(hdp.get("batch_size", 1))
        self.shuffle = hdp.get("shuffle") in (True, "true")
        source = str(hdp.get("source"))
        base = os.path.dirname(os.path.abspath(source))
        with open(source) as f:
            self.files = [ln.strip() if os.path.isabs(ln.strip())
                          else os.path.join(base, ln.strip())
                          for ln in f if ln.strip()]
        if not self.files:
            raise ValueError(f"no HDF5 files listed in {source}")
        self._h5py = h5py
        self._rng = np.random.default_rng(seed)
        self._file_perm = np.arange(len(self.files))
        if self.shuffle:
            self._rng.shuffle(self._file_perm)
        self._file_idx = 0
        self.decoded = 0            # rows copied into batches so far
        self._load_file()

    def _read_file(self, path: str) -> None:
        with self._h5py.File(path, "r") as f:
            data = {t: np.asarray(f[t]).astype(np.float32)
                    for t in self.tops}
        n = data[self.tops[0]].shape[0]
        for t in self.tops:
            if data[t].shape[0] != n:
                raise ValueError(
                    f"dataset {t} rows {data[t].shape[0]} != {n} in {path}")
        self._data = data

    def _load_file(self) -> None:
        """Read the current file and draw its row order."""
        self._read_file(self.files[self._file_perm[self._file_idx]])
        self._perm = np.arange(self._data[self.tops[0]].shape[0])
        if self.shuffle:
            self._rng.shuffle(self._perm)
        self._row = 0

    def _advance_file(self) -> None:
        self._file_idx += 1
        if self._file_idx >= len(self.files):
            self._file_idx = 0
            if self.shuffle:
                self._rng.shuffle(self._file_perm)
        self._load_file()

    def next_batch(self, part: tuple[int, int] | None = None
                   ) -> tuple[np.ndarray, ...]:
        """One array per top, wrapping across files (ref Forward_cpu), or
        with ``part = (i, n)`` the i-th of n equal row blocks: every file
        the whole batch crosses is still loaded and advanced."""
        i, n = part or (0, 1)
        if self.batch_size % n:
            raise ValueError(f"batch of {self.batch_size} does not split "
                             f"into {n} parts")
        k = self.batch_size // n
        lo, hi = i * k, (i + 1) * k         # this block's rows
        chunks: list[list[np.ndarray]] = [[] for _ in self.tops]
        start = 0                           # batch row of this chunk
        while start < self.batch_size:
            rows_left = self._perm.shape[0] - self._row
            take = min(self.batch_size - start, rows_left)
            a, b = max(lo, start), min(hi, start + take)
            if a < b:
                rows = self._perm[self._row + a - start:self._row + b - start]
                for c, t in zip(chunks, self.tops):
                    c.append(self._data[t][rows])
                self.decoded += b - a
            self._row += take
            start += take
            if self._row >= self._perm.shape[0]:
                self._advance_file()
        return tuple(np.concatenate(c, axis=0) for c in chunks)

    def state(self) -> dict[str, np.ndarray]:
        """The stream's position: the file index, the row position, both
        permutations and the generator."""
        return {"file_idx": np.asarray(self._file_idx),
                "row": np.asarray(self._row),
                "file_perm": self._file_perm.copy(),
                "perm": self._perm.copy(),
                "rng": np.asarray(json.dumps(
                    self._rng.bit_generator.state))}

    def set_state(self, state: dict) -> None:
        self._file_idx = int(state["file_idx"])
        self._file_perm = np.asarray(state["file_perm"]).copy()
        self._read_file(self.files[self._file_perm[self._file_idx]])
        self._perm = np.asarray(state["perm"]).copy()
        self._row = int(state["row"])
        self._rng.bit_generator.state = json.loads(str(state["rng"]))

    def __iter__(self):
        while True:
            yield self.next_batch()
