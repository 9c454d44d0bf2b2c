"""MemoryData source: in-memory array batches (port of
``nct_tpu/data/memory_data.py``).

Rebuilds src/caffe/layers/memory_data_layer.cpp: the caller hands the
layer preloaded arrays (``Reset`` / pycaffe ``set_input_arrays``); each
forward serves the next ``batch_size`` rows, wrapping around.  Arrays are
taken as they are given (NCHW for images, as the port's nets want)."""

from __future__ import annotations

import numpy as np


class MemoryDataSource:
    """``type: "MemoryData"`` layer analogue.  Arrays arrive either via
    ``reset(data, labels)`` (the memory_data_layer.cpp Reset contract) or
    inline in the layer config under ``__arrays__``."""

    def __init__(self, layer_cfg: dict, phase: str = "TRAIN",
                 seed: int = 0):
        mp = layer_cfg.get("memory_data_param", {}) or {}
        self.batch_size = int(mp.get("batch_size", 1))
        self.pos = 0
        self.data = None
        self.labels = None
        arrays = layer_cfg.get("__arrays__")
        if arrays is not None:
            self.reset(*arrays)

    def reset(self, data: np.ndarray, labels: np.ndarray) -> None:
        """Swap in a new dataset (Reset: its size must divide into batches,
        as the reference CHECKs)."""
        data = np.asarray(data, np.float32)
        labels = np.asarray(labels, np.float32)
        if len(data) != len(labels):
            raise ValueError("data/label count mismatch")
        if len(data) % self.batch_size:
            raise ValueError(
                f"size {len(data)} not divisible by batch_size "
                f"{self.batch_size} (memory_data_layer.cpp Reset)")
        self.data, self.labels = data, labels
        self.pos = 0

    def next_batch(self, part: tuple[int, int] | None = None):
        """The next batch, or with ``part = (i, n)`` its i-th of n equal
        row blocks."""
        if self.data is None:
            raise RuntimeError(
                "MemoryData needs reset(data, labels) before forward "
                "(memory_data_layer.cpp: 'MemoryDataLayer needs to be "
                "initialized by calling Reset')")
        n = len(self.data)
        idx = [(self.pos + i) % n for i in range(self.batch_size)]
        self.pos = (self.pos + self.batch_size) % n
        if part is not None:
            i, parts = part
            if self.batch_size % parts:
                raise ValueError(f"batch of {self.batch_size} does not "
                                 f"split into {parts} parts")
            k = self.batch_size // parts
            idx = idx[i * k:(i + 1) * k]
        return self.data[idx], self.labels[idx]

    def state(self) -> dict[str, np.ndarray]:
        return {"pos": np.asarray(self.pos)}

    def set_state(self, state: dict) -> None:
        self.pos = int(state["pos"])

    def __iter__(self):
        while True:
            yield self.next_batch()
